"""OPT-EXEC-PLAN (paper §5.2, Algorithm 1) — optimal reuse planning.

Given per-node compute cost ``c_i``, load cost ``l_i`` (``None`` when no
equivalent materialization exists, i.e. l_i = ∞), and the set of *original*
(changed/new) nodes, assign each node a state in {COMPUTE, LOAD, PRUNE}
minimizing total runtime

    T(W, s) = Σ_i  1[s_i = C]·c_i + 1[s_i = L]·l_i

subject to
  * Constraint 1 — original nodes must be computed,
  * Constraint 2 — a computed node's parents must not be pruned,
  * mandatory outputs must not be pruned.

The paper reduces this to the Project-Selection Problem: per node, project
``a_i`` (profit −l_i; "don't prune") and ``b_i`` (profit l_i − c_i; "and
compute"), with prerequisites b_i→a_i and b_j→a_i for every DAG edge
(n_i parent of n_j). PSP is solved exactly by min-cut / max-flow; we use
Dinic's algorithm (graphs here have O(|N|) projects, O(|E|) prerequisites —
milliseconds even for thousands of operators).

Costs are converted to integer microseconds so the flow network is exact
(Python bigints: no overflow, no float drift).
"""
from __future__ import annotations

import itertools
from typing import Iterable, Mapping

from .dag import DAG, State, validate_states

_US = 1_000_000  # seconds → integer microseconds


class _Dinic:
    """Max-flow (Dinic). Integer capacities."""

    def __init__(self, n: int):
        self.n = n
        self.adj: list[list[list[int]]] = [[] for _ in range(n)]
        # edge = [to, cap, index_of_reverse_in_adj[to]]

    def add_edge(self, u: int, v: int, cap: int) -> None:
        self.adj[u].append([v, cap, len(self.adj[v])])
        self.adj[v].append([u, 0, len(self.adj[u]) - 1])

    def _bfs(self, s: int, t: int) -> bool:
        self.level = [-1] * self.n
        self.level[s] = 0
        q = [s]
        while q:
            nq = []
            for u in q:
                for e in self.adj[u]:
                    v, cap, _ = e
                    if cap > 0 and self.level[v] < 0:
                        self.level[v] = self.level[u] + 1
                        nq.append(v)
            q = nq
        return self.level[t] >= 0

    def _dfs(self, u: int, t: int, f: int) -> int:
        if u == t:
            return f
        while self.it[u] < len(self.adj[u]):
            e = self.adj[u][self.it[u]]
            v, cap, rev = e
            if cap > 0 and self.level[v] == self.level[u] + 1:
                d = self._dfs(v, t, min(f, cap))
                if d > 0:
                    e[1] -= d
                    self.adj[v][rev][1] += d
                    return d
            self.it[u] += 1
        return 0

    def max_flow(self, s: int, t: int) -> int:
        flow = 0
        INF = 1 << 62
        while self._bfs(s, t):
            self.it = [0] * self.n
            while True:
                f = self._dfs(s, t, INF)
                if f == 0:
                    break
                flow += f
        return flow

    def min_cut_side(self, s: int) -> set[int]:
        """Nodes reachable from s in the residual graph (source side)."""
        seen = {s}
        stack = [s]
        while stack:
            u = stack.pop()
            for v, cap, _ in self.adj[u]:
                if cap > 0 and v not in seen:
                    seen.add(v)
                    stack.append(v)
        return seen


def plan(dag: DAG,
         compute_cost: Mapping[str, float],
         load_cost: Mapping[str, float | None],
         original: Iterable[str]) -> dict[str, State]:
    """Solve OPT-EXEC-PLAN exactly. Returns ``{name: State}``.

    ``load_cost[name] is None`` ⇔ no equivalent materialization (l=∞).
    ``original`` nodes are forced to COMPUTE (Constraint 1).
    Nodes flagged ``is_output`` are forced non-PRUNE.

    Precondition (as in the paper, where slicing runs first): every node is
    an output or an ancestor of one. On such DAGs the l=∞/c=−ε encoding of
    Constraint 1 provably forces original nodes to COMPUTE, because an
    original node's descendants are all original (recursive signatures) down
    to a mandatory output.
    """
    original = set(original)
    names = dag.topological()
    # --- integer cost model -------------------------------------------------
    finite: list[int] = []
    for n in names:
        finite.append(max(0, int(round(compute_cost[n] * _US))))
        lc = load_cost.get(n)
        if lc is not None:
            finite.append(max(0, int(round(lc * _US))))
    INF_COST = sum(finite) + 1_000_000          # "∞" load cost
    BONUS = (INF_COST + 1) * (len(names) + 2)   # must-not-prune forcing bonus
    EPS = 1                                     # original-compute tiebreaker

    c: dict[str, int] = {}
    l: dict[str, int] = {}
    bonus: dict[str, int] = {}
    for n in names:
        node = dag.nodes[n]
        if n in original:
            # Paper Appendix B: l=∞, c=−ε makes COMPUTE the unique optimum.
            c[n] = -EPS
            l[n] = INF_COST
        else:
            c[n] = max(0, int(round(compute_cost[n] * _US)))
            lc = load_cost.get(n)
            l[n] = INF_COST if lc is None else max(0, int(round(lc * _US)))
        bonus[n] = BONUS if node.is_output else 0

    # --- PSP → min-cut -------------------------------------------------------
    # project ids: a_i = 2k, b_i = 2k+1
    idx = {n: i for i, n in enumerate(names)}
    NP_ = 2 * len(names)
    S, T = NP_, NP_ + 1
    g = _Dinic(NP_ + 2)
    total_pos = 0
    INF_EDGE = 1 << 61

    def add_project(pid: int, profit: int) -> None:
        nonlocal total_pos
        if profit > 0:
            g.add_edge(S, pid, profit)
            total_pos += profit
        elif profit < 0:
            g.add_edge(pid, T, -profit)

    for n in names:
        a, b = 2 * idx[n], 2 * idx[n] + 1
        add_project(a, -l[n] + bonus[n])
        add_project(b, l[n] - c[n])
        g.add_edge(b, a, INF_EDGE)  # b_i requires a_i
        for p in dag.nodes[n].parents:
            g.add_edge(b, 2 * idx[p], INF_EDGE)  # b_child requires a_parent

    g.max_flow(S, T)
    side = g.min_cut_side(S)

    states: dict[str, State] = {}
    for n in names:
        a, b = 2 * idx[n], 2 * idx[n] + 1
        if a in side and b in side:
            states[n] = State.COMPUTE
        elif a in side:
            states[n] = State.LOAD
        else:
            states[n] = State.PRUNE

    # --- sanity (Theorem 2 guarantees these; cheap to assert) ---------------
    validate_states(dag, states)
    for n in original:
        if states[n] is not State.COMPUTE and _reachable_from_needed(dag, n, states):
            raise AssertionError(f"Constraint 1 violated for original node {n}")
    return states


def _reachable_from_needed(dag: DAG, n: str, states: dict[str, State]) -> bool:
    # An original node may legitimately be PRUNEd only if nothing non-pruned
    # depends on it and it is not an output (the slicing pass normally removes
    # such nodes before planning).
    if dag.nodes[n].is_output:
        return True
    return any(states[ch] is State.COMPUTE for ch in dag.children(n))


def plan_runtime(dag: DAG,
                 states: Mapping[str, State],
                 compute_cost: Mapping[str, float],
                 load_cost: Mapping[str, float | None]) -> float:
    """T(W, s) with the *real* costs (Eq. 1)."""
    t = 0.0
    for n in dag.topological():
        s = states[n]
        if s is State.COMPUTE:
            t += compute_cost[n]
        elif s is State.LOAD:
            lc = load_cost.get(n)
            assert lc is not None, f"loaded {n} without materialization"
            t += lc
    return t


def brute_force_plan(dag: DAG,
                     compute_cost: Mapping[str, float],
                     load_cost: Mapping[str, float | None],
                     original: Iterable[str]) -> tuple[dict[str, State], float]:
    """Exhaustive optimal plan for small *sliced* DAGs (oracle for Thm. 2).

    Applies Constraint 1 strictly: original ⇒ COMPUTE (the paper's wording).
    """
    original = set(original)
    names = dag.topological()
    best: tuple[float, dict[str, State]] | None = None
    choices = []
    for n in names:
        if n in original:
            opts = [State.COMPUTE]  # Constraint 1, strict
        else:
            opts = [State.COMPUTE, State.PRUNE]
            if load_cost.get(n) is not None:
                opts.append(State.LOAD)
        if dag.nodes[n].is_output:
            opts = [o for o in opts if o is not State.PRUNE]
        choices.append(opts)
    for combo in itertools.product(*choices):
        states = dict(zip(names, combo))
        try:
            validate_states(dag, states)
        except ValueError:
            continue
        t = plan_runtime(dag, states, compute_cost, load_cost)
        if best is None or t < best[0] - 1e-12:
            best = (t, states)
    assert best is not None
    return best[1], best[0]
