"""DFS topological sort with optional forced head.

Copy of the JAX package's `utils/topo.py`, which follows the original
system's `trainers/topological_sort.py` visit order. The exact visit order matters for decode tie-breaking: vertices are visited in
ascending index order, adjacency lists in insertion order, and each finished
vertex is pushed to the *front* of the result stack.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional


class Graph:
    """Adjacency-list digraph over vertices 0..V-1 (`topological_sort.py:8-31`)."""

    def __init__(self, vertices: int):
        self.graph = defaultdict(list)
        self.V = vertices

    def addEdge(self, u: int, v: int) -> None:
        self.graph[u].append(v)

    # alias with pythonic name
    add_edge = addEdge

    def _visit(self, v: int, visited: List[bool], stack: List[int]) -> None:
        # Mirrors the reference recursion (`topological_sort.py:18-29`):
        # push v to the front of `stack` only after all successors finish,
        # successors explored in list order.
        visited[v] = True
        for i in self.graph[v]:
            if not visited[i]:
                self._visit(i, visited, stack)
        stack.insert(0, v)

    def topologicalSort(self, assert_head: Optional[int] = None) -> List[int]:
        """DFS topo order; `assert_head` forces that vertex first by inserting
        head→v edges and visiting the head last (`topological_sort.py:33-70`)."""
        if assert_head is not None:
            for v in list(self.graph.keys()):
                if v != assert_head and v not in self.graph[assert_head]:
                    self.graph[assert_head].insert(0, v)

        visited = [False] * self.V
        stack: List[int] = []
        for i in range(self.V):
            if assert_head is None:
                if not visited[i]:
                    self._visit(i, visited, stack)
            else:
                if not visited[i] and i != assert_head:
                    self._visit(i, visited, stack)

        if assert_head is not None:
            if assert_head in stack:
                stack.remove(assert_head)
            self._visit(assert_head, visited, stack)
            assert stack[0] == assert_head, "Asserting head failed"

        return stack

    topological_sort = topologicalSort
