"""Chu-Liu-Edmonds maximum spanning arborescence.

Copy of the JAX package's `utils/mst.py` (dict-graph convention:
`{node: {nbh: weight}}`, node 0 acts as root and never receives an edge).
Used by the `mst` heatmap decode method. The `mst.py:...` line references
point into the original system's parser module.
"""

from __future__ import annotations

SMALL_WEIGHT = -1000000  # -inf sentinel, matches reference `mst.py:9`


def _best_incoming(graph):
    """Max-weight incoming edge per node (`mst.py:11-24`)."""
    vertices = list(graph.keys())
    best = {v: (0, SMALL_WEIGHT) for v in vertices}
    for u, nbhs in graph.items():
        for v, w in nbhs.items():
            if w > best[v][1]:
                best[v] = (u, w)
    return best


def _find_cycle(best_pred):
    """Return a cycle [c0, c1, ..., c0] in the best-predecessor selection, or
    [] if none (`mst.py:26-61`)."""
    vertices = list(best_pred.keys())
    visited = {v: -1 for v in vertices}
    visited[0] = 0
    for i in vertices:
        cycle = [i]
        if visited[i] == -1:
            pred = best_pred[i][0]
            visited[i] = i
            while visited[pred] == -1:
                cycle.append(pred)
                visited[pred] = i
                pred = best_pred[pred][0]
            if visited[pred] == i:
                start = cycle.index(pred)
                cycle = cycle[start:] + [cycle[start]]
                cycle.reverse()
                return cycle
    return []


def _contract(graph, cycle):
    """Contract `cycle` into a supernode (`mst.py:63-127`)."""
    vertices = list(graph.keys())
    len_cycle = len(cycle)

    cycle_weight = sum(
        graph[cycle[i - 1]][cycle[i]] for i in range(1, len_cycle))

    incoming = {v: (SMALL_WEIGHT, -1) for v in vertices}
    for i in vertices:
        if i in cycle:
            continue
        for j in range(1, len_cycle):
            vtx, pred = cycle[j], cycle[j - 1]
            w = cycle_weight - graph[pred][vtx] + graph[i][vtx]
            if w > incoming[i][0]:
                incoming[i] = (w, vtx)

    outgoing = {v: (SMALL_WEIGHT, -1) for v in vertices}
    for i in vertices:
        if i not in cycle and i != 0:
            for vtx in cycle:
                if graph[vtx][i] > outgoing[i][0]:
                    outgoing[i] = (graph[vtx][i], vtx)

    new_node = max(vertices) + 1
    new_graph = {new_node: {}}
    for u, nbhs in graph.items():
        if u in cycle:
            continue
        new_graph[u] = {v: w for v, w in nbhs.items() if v not in cycle}
        new_graph[u][new_node] = incoming[u][0]
        if u != 0:
            new_graph[new_node][u] = outgoing[u][0]

    to_cycle = {v: p[1] for v, p in incoming.items() if v not in cycle}
    from_cycle = {v: p[1] for v, p in outgoing.items()
                  if v not in cycle and v != 0}
    return new_graph, to_cycle, from_cycle


def cle(graph):
    """Recursive CLE returning best-predecessor map (`mst.py:129-174`)."""
    best_pred = _best_incoming(graph)
    cycle = _find_cycle(best_pred)
    if not cycle:
        return best_pred

    new_graph, to_cycle, from_cycle = _contract(graph, cycle)
    best_new = cle(new_graph)

    cycle_index = max(graph.keys()) + 1
    x = best_new[cycle_index][0]
    c = to_cycle[x]
    pos_c = cycle.index(c)
    if pos_c == 0:
        pos_c = len(cycle) - 1

    new_best = {}
    for v in best_new:
        if v == cycle_index:
            new_best[c] = (x, graph[x][c])
            for i in range(1, len(cycle)):
                if i != pos_c:
                    new_best[cycle[i]] = best_pred[cycle[i]]
        elif best_new[v][0] != cycle_index:
            new_best[v] = best_new[v]
        else:
            new_best[v] = (from_cycle[v], best_new[v][1])
    return new_best


def mst(graph):
    """Max spanning arborescence as `{parent: {child: weight}}` (`mst.py:176-189`)."""
    best_pred = cle(graph)
    tree = {v: {} for v in graph}
    for v, (p, w) in best_pred.items():
        if not (v == 0 and p == 0):
            tree[p][v] = w
    return tree
