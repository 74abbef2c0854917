"""Run the reference's benches by name on the port (twin of the JAX
package's ``benchmarks/run.py`` ``main`` and its ``__main__``, :1020-1048).

    python -m repro_torch.launch.bench                       # all 14, on the card
    python -m repro_torch.launch.bench bench_engine_overlap --device cpu
    HELIX_BENCH_SWEEP_SCALE=0.05 python -m repro_torch.launch.bench \\
        bench_sweep_reuse --device cpu

Each of ``benchmarks/run.py``'s 14 names runs the port's twin, from
``launch/bench_workflows.py``, ``bench_engine.py``, ``bench_fleet.py`` or
``bench_tier.py``; with no name, the whole suite runs in the reference's
order. An unknown name exits with the reference's message and the sorted
names. The reference's environment knobs are read with its defaults
(``Knobs.from_env``). The three workflow benches share one set of NM / AM
/ OPT runs, as the reference's ``_results`` cache does. BLAS is pinned to
one thread before numpy loads, as in the reference. Workdirs go under a
temporary directory, removed at the end. The CLI prints the thread counts
it ran with first.
"""
from __future__ import annotations

import os
import sys

from . import _blas

if __name__ == "__main__":
    _blas.pin()       # before numpy and torch load, as the reference does

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

from .. import workflows as W  # noqa: E402
from ..device import resolve  # noqa: E402
from . import bench_engine, bench_fleet, bench_tier, bench_workflows  # noqa: E402

# the reference's suite, in its order (benchmarks/run.py main)
BENCHES = ("bench_cumulative_runtime", "bench_storage",
           "bench_state_fractions", "bench_optimizer_overhead",
           "bench_parallel_speedup", "bench_sweep_reuse",
           "bench_server_reuse", "bench_eviction", "bench_remote_reuse",
           "bench_search_reuse", "bench_incremental", "bench_tier",
           "bench_engine_overlap", "bench_multitenant")


@dataclasses.dataclass(frozen=True)
class Knobs:
    """The reference's environment knobs, with its defaults."""
    iters: int = 10                               # HELIX_BENCH_ITERS
    workflows: tuple[str, ...] = bench_workflows.SURVEY  # _WORKFLOWS
    par_workers: int = bench_engine.default_workers()    # _PAR_WORKERS
    sweep_variants: int = 4                       # _SWEEP_VARIANTS
    sweep_scale: float = 1.0                      # _SWEEP_SCALE
    lm_steps: int = 4                             # _LM_STEPS
    lm_dm: int = 128                              # _LM_DM
    tenant_families: int = 6                      # _TENANT_FAMILIES
    chaos_seed: int = 1234                        # HELIX_CHAOS_SEED
    inc_chunks: int = 10                          # _INC_CHUNKS
    inc_rows: int = 8000                          # _INC_ROWS

    @classmethod
    def from_env(cls, env=None) -> "Knobs":
        env = os.environ if env is None else env
        d = cls()

        def get(name, default, cast=int):
            return cast(env.get(name, str(default)))
        return cls(
            iters=get("HELIX_BENCH_ITERS", d.iters),
            workflows=tuple(env.get("HELIX_BENCH_WORKFLOWS",
                                    ",".join(d.workflows)).split(",")),
            par_workers=get("HELIX_BENCH_PAR_WORKERS", d.par_workers),
            sweep_variants=get("HELIX_BENCH_SWEEP_VARIANTS",
                               d.sweep_variants),
            sweep_scale=get("HELIX_BENCH_SWEEP_SCALE", d.sweep_scale, float),
            lm_steps=get("HELIX_BENCH_LM_STEPS", d.lm_steps),
            lm_dm=get("HELIX_BENCH_LM_DM", d.lm_dm),
            tenant_families=get("HELIX_BENCH_TENANT_FAMILIES",
                                d.tenant_families),
            chaos_seed=get("HELIX_CHAOS_SEED", d.chaos_seed),
            inc_chunks=get("HELIX_BENCH_INC_CHUNKS", d.inc_chunks),
            inc_rows=get("HELIX_BENCH_INC_ROWS", d.inc_rows))


class Suite:
    """The 14 benches as methods of one run: ``root`` holds the workdirs,
    ``knobs`` the sizes, and every bench runs on ``device``."""

    def __init__(self, root: str, knobs: Knobs, device) -> None:
        self.root, self.knobs, self.device = root, knobs, resolve(device)
        self._policy_runs = None

    def policy_runs(self) -> dict:
        """NM / AM / OPT runs of the selected workflows, made once."""
        if self._policy_runs is None:
            self._policy_runs = {
                name: bench_workflows.run_policies(
                    W.WORKFLOWS[name], self.root, self.knobs.iters,
                    device=self.device)
                for name in self.knobs.workflows}
        return self._policy_runs

    def _fleet(self, name: str, **kw) -> dict:
        return bench_fleet.BENCHES[name](
            self.root, scale=self.knobs.sweep_scale, device=self.device,
            **kw)

    def bench_cumulative_runtime(self):
        return bench_workflows.bench_cumulative_runtime(self.policy_runs(),
                                                        self.device)

    def bench_storage(self):
        return bench_workflows.bench_storage(self.policy_runs(), self.device)

    def bench_state_fractions(self):
        return bench_workflows.bench_state_fractions(self.policy_runs(),
                                                     self.device)

    def bench_optimizer_overhead(self):
        return bench_engine.bench_optimizer_overhead(device=self.device)

    def bench_parallel_speedup(self):
        return bench_engine.bench_parallel_speedup(
            self.root, n_workers=self.knobs.par_workers, device=self.device)

    def bench_sweep_reuse(self):
        return self._fleet("sweep_reuse", n_var=self.knobs.sweep_variants)

    def bench_server_reuse(self):
        return self._fleet("server_reuse", n_var=self.knobs.sweep_variants)

    def bench_eviction(self):
        return self._fleet("eviction", n_var=self.knobs.sweep_variants)

    def bench_remote_reuse(self):
        return self._fleet("remote_reuse", n_var=self.knobs.sweep_variants)

    def bench_search_reuse(self):
        return self._fleet("search_reuse", n_var=self.knobs.sweep_variants)

    def bench_incremental(self):
        return bench_workflows.bench_incremental(
            self.root, self.knobs.inc_chunks, self.knobs.inc_rows,
            device=self.device)

    def bench_tier(self):
        k = dataclasses.replace(W.LMKnobs(), steps=self.knobs.lm_steps,
                                d_model=self.knobs.lm_dm)
        return bench_tier.bench_tier(os.path.join(self.root, "lm_tier"), k,
                                     device=self.device).stats

    def bench_engine_overlap(self):
        return bench_engine.bench_engine_overlap(device=self.device)

    def bench_multitenant(self):
        return self._fleet("multitenant",
                           families=self.knobs.tenant_families,
                           seed=self.knobs.chaos_seed)


def refusal(names) -> str | None:
    """The reference's message for the first of ``names`` that is not a
    bench, or None."""
    unknown = [n for n in names if n not in BENCHES]
    if not unknown:
        return None
    return (f"unknown benchmark {unknown[0]!r}; available: "
            + ", ".join(sorted(BENCHES)))


def run(names=BENCHES, *, device=None, knobs: Knobs | None = None) -> dict:
    """Run the benches ``names`` in order; returns each one's numbers by
    name. Raises ``ValueError`` on a name that is not one of ``BENCHES``."""
    msg = refusal(names)
    if msg:
        raise ValueError(msg)
    root = tempfile.mkdtemp(prefix="helix-bench-")
    try:
        suite = Suite(root, knobs or Knobs.from_env(), device)
        return {name: getattr(suite, name)() for name in names}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", metavar="bench_name",
                    help="benches to run (default: the whole suite)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    msg = refusal(args.names)
    if msg:
        sys.exit(msg)
    print("# threads: " + ";".join(f"{k}={v}" for k, v in
                                   _blas.threads().items()), flush=True)
    return run(args.names or BENCHES, device=args.device)


if __name__ == "__main__":
    main()
