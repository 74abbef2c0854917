"""Session server: several "users" iterating concurrently on one host
(twin of the JAX package's ``examples/session_server.py``).

Starts a ``SessionServer`` on a scratch workdir, exposes it on a unix
socket, and drives it from three concurrent clients: two iterating on the
census workflow (they share the data pipeline and, when their ``reg``
matches, the trained model), one on an independent toy workflow. The
server's global scheduler orders submissions shared-prefix-first, and the
dispatch log shows who ran when. Census's learner runs on ``--device``.

    python -m repro_torch.examples.session_server              # on the card
    python -m repro_torch.examples.session_server --device cpu --rows 2000

The workdir (and the socket in it) goes under a temporary directory,
removed at the end.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import threading

import numpy as np

from .. import workflows as W
from ..core import EngineConfig, Workflow
from ..device import resolve
from ..serve import SessionServer, connect_unix


def census_builder(n_rows: int, device):
    def build_census(reg: float = 0.1, eval_threshold: float = 0.5):
        knobs = W.CensusKnobs(n_rows=n_rows, reg=reg,
                              eval_threshold=eval_threshold)
        return W.build_census(knobs, device=device)
    return build_census


def build_toy(scale: float = 1.0):
    wf = Workflow("toy")
    src = wf.source("grid", lambda: np.linspace(0, 1, 200_000),
                    config="v1")
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    out = wf.reducer("area", lambda x, s=scale: {
        "area": float(trapezoid(np.sin(x * np.pi) * s, x))},
        [src], config=("s", scale))
    wf.output(out)
    return wf


USERS = [("alice", "census", {"reg": 0.1, "eval_threshold": 0.5}),
         ("bob", "census", {"reg": 0.1, "eval_threshold": 0.7}),
         ("carol", "toy", {"scale": 2.0})]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=20_000,
                    help="census rows (the reference's 20,000)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    workdir = tempfile.mkdtemp(prefix="helix-serve-demo-")
    try:
        server = SessionServer(
            workdir,
            registry={"census": census_builder(args.rows, dev),
                      "toy": build_toy},
            engine=EngineConfig(n_sessions=2, pool_workers=4))
        try:
            sock = server.serve_unix(os.path.join(workdir, "helix.sock"))
            print(f"server on {sock} (schedule={server.scheduler.mode})")
            results, errors = {}, []

            def user(name: str, workflow: str, params: dict) -> None:
                try:
                    client = connect_unix(sock)
                    try:
                        job = client.submit(workflow, params, name=name)
                        results[name] = client.wait(job)
                    finally:
                        client.close()
                except Exception as e:      # re-raised on the main thread
                    errors.append(e)

            threads = [threading.Thread(target=user, args=u) for u in USERS]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            server.shutdown()
        if errors:
            raise errors[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print(f"dispatch order: {server.dispatch_log}")
    for name, summary in sorted(results.items()):
        ex = summary["execution"]
        print(f"{name:6s} {summary['status']:5s} "
              f"run={summary['run_seconds']:.2f}s "
              f"computed={ex['n_computed']} loaded={ex['n_loaded']} "
              f"deduped={ex['n_deduped']} -> {summary['outputs']}")
    return {"dispatch_log": list(server.dispatch_log), "results": results}


if __name__ == "__main__":
    main()
