"""Execution planner: topological sort with cycle breaking (counterpart:
``srack_tpu/planner.py``, its pure-Python path).

The reference planner's observable semantics:

1. build the sink -> sources edge multimap from every module's connected
   inputs;
2. walk the graph depth-first from the module list (output visited first)
   and, at each visited module, repeatedly run the ``is_loop`` breadth-first
   search; every time a node ``from`` is found whose dependency list
   contains the probed module, delete ALL ``from -> module`` edge entries;
3. repeatedly emit the first module (in list order) whose remaining
   dependencies have all been emitted.

Deleted ("broken") edges are the feedback reads; the compiler reconstructs
them from plan positions.  The C++ planner (``native/planner.cpp``, bound
by ``native.py``) implements the same steps and runs first when its
library builds.
"""

from __future__ import annotations

from .patch import Patch


def _build_edges(patch: Patch) -> dict[str, list[str]]:
    """sink -> sources (duplicates preserved, input-port order)."""
    return {
        inst.id: [c[0] for c in inst.inputs if c is not None]
        for inst in patch
    }


def _is_loop(module: str, edges: dict[str, list[str]]):
    """BFS from ``module``; returns the first node whose dependency list
    contains ``module`` (the back-edge holder), or None (synth.rs:107-126)."""
    to_search = [module]
    visited: set[str] = set()
    while True:
        current = next((m for m in to_search if m not in visited), None)
        if current is None:
            return None
        visited.add(current)
        to_add = []
        for dep in edges[current]:
            if dep == module:
                return current
            to_add.append(dep)
        to_search.extend(to_add)


def plan_execution(patch: Patch, use_native: bool = True):
    """Returns ``(plan, broken)``.

    ``plan`` is the execution order (module ids, every module included);
    ``broken`` is the set of deleted feedback edges as (sink_id, src_id)
    pairs (the sink's dependency on src is ignored for ordering).

    ``use_native``: take the C++ planner when its library is available
    (the same semantics; the tests hold the two equal), else the
    pure-Python one below.
    """
    if patch.output is None:
        raise ValueError("patch has no Output module")
    all_modules = patch.module_ids
    output = patch.output.id

    edges = _build_edges(patch)

    if use_native:
        from . import native
        result = native.plan_execution_native(all_modules, edges, output)
        if result is not None:
            return result
    broken: set[tuple[str, str]] = set()

    # Phase 2: DFS from output-first, breaking cycles (synth.rs:168-192).
    to_search = list(all_modules) + [output]
    visited: set[str] = set()
    while to_search:
        module = to_search.pop()
        if module in visited:
            continue
        visited.add(module)
        to_search.extend(edges[module])
        while True:
            frm = _is_loop(module, edges)
            if frm is None:
                break
            edges[frm] = [d for d in edges[frm] if d != module]
            broken.add((frm, module))

    # Phase 3: emit first module (list order) whose deps are all emitted
    # (synth.rs:193-211).
    emitted: set[str] = set()
    plan: list[str] = []
    while True:
        node = next(
            (m for m in all_modules
             if m not in emitted and all(d in emitted for d in edges[m])),
            None)
        if node is None:
            break
        emitted.add(node)
        plan.append(node)

    if len(plan) != len(all_modules):  # pragma: no cover - cycle break guarantees DAG
        missing = [m for m in all_modules if m not in emitted]
        raise RuntimeError(f"planner failed to order modules: {missing}")
    return plan, broken
