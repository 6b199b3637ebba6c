"""8-connected grid Dijkstra (host-side).

Capability parity with the reference planner (``planning/dijkstra.py:17-260``)
with the same coordinate conventions — start/goal in world-relative meters,
grid index = round(pos / resolution), diagonal cost sqrt(2), obstacle map
indexed [x][y], path returned goal→start as (rx, ry) in meters — but built
on a binary heap instead of the reference's O(V^2) min-over-dict scan.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Optional, Tuple

import numpy as np

_MOTION = [
    (1, 0, 1.0),
    (0, 1, 1.0),
    (-1, 0, 1.0),
    (0, -1, 1.0),
    (-1, -1, math.sqrt(2)),
    (-1, 1, math.sqrt(2)),
    (1, -1, math.sqrt(2)),
    (1, 1, math.sqrt(2)),
]


class Dijkstra:
    def __init__(self, aabb, planning_map: np.ndarray, resolution: float,
                 robot_radius: float = 0.05):
        self.resolution = resolution
        self.robot_radius = robot_radius
        self.min_x = 0.0
        self.min_y = 0.0
        self.max_x = aabb[3] - aabb[0]
        self.max_y = aabb[4] - aabb[1]
        self.obstacle_map = np.asarray(planning_map)
        self.x_width, self.y_width = self.obstacle_map.shape

    def _index(self, pos: float) -> int:
        return int(round(pos / self.resolution))

    def _pos(self, index: int) -> float:
        return index * self.resolution

    def _ok(self, x: int, y: int) -> bool:
        px, py = self._pos(x), self._pos(y)
        if px < 0 or py < 0 or px >= self.max_x or py >= self.max_y:
            return False
        if x < 0 or y < 0 or x >= self.x_width or y >= self.y_width:
            return False
        return not bool(self.obstacle_map[x, y])

    def planning(
        self, sx: float, sy: float, gx: float, gy: float,
        use_native: bool = True,
    ) -> Optional[Tuple[List[float], List[float]]]:
        """→ (rx, ry) world-unit path goal→start, or None if unreachable."""
        start = (self._index(sx), self._index(sy))
        goal = (self._index(gx), self._index(gy))
        if use_native:
            path = self._planning_native(start, goal)
            if path is not False:  # False = native unavailable
                return path
        dist = {start: 0.0}
        parent = {}
        heap = [(0.0, start)]
        visited = set()
        found = False
        while heap:
            cost, node = heapq.heappop(heap)
            if node in visited:
                continue
            visited.add(node)
            if node == goal:
                found = True
                break
            for dx, dy, c in _MOTION:
                nxt = (node[0] + dx, node[1] + dy)
                if nxt in visited or not self._ok(*nxt):
                    continue
                ncost = cost + c
                if ncost < dist.get(nxt, float("inf")):
                    dist[nxt] = ncost
                    parent[nxt] = node
                    heapq.heappush(heap, (ncost, nxt))
        if not found:
            return None
        rx, ry = [self._pos(goal[0])], [self._pos(goal[1])]
        node = goal
        while node in parent:
            node = parent[node]
            rx.append(self._pos(node[0]))
            ry.append(self._pos(node[1]))
        return rx, ry

    def _planning_native(self, start, goal):
        """C++ fast path (``native/planning_core.cpp``). The native
        grid has no world-bound margin handling, so out-of-grid
        starts/goals and boundary clipping are pre-applied here the same
        way ``_ok`` does."""
        from ..native import dijkstra_plan_native, is_available

        if not is_available():
            return False
        # mark cells outside the world bounds as obstacles (the Python
        # path rejects them in _ok via max_x/max_y position checks)
        obstacle = np.array(self.obstacle_map != 0, dtype=np.uint8)
        xs = np.arange(self.x_width) * self.resolution
        ys = np.arange(self.y_width) * self.resolution
        obstacle[(xs < self.min_x) | (xs >= self.max_x), :] = 1
        obstacle[:, (ys < self.min_y) | (ys >= self.max_y)] = 1
        if not (0 <= start[0] < self.x_width and 0 <= start[1] < self.y_width):
            return False  # out-of-grid start: let the Python path handle it
        # start cell itself may sit on an obstacle reading; the Python
        # version never verifies the start node, so clear it.
        obstacle[start[0], start[1]] = 0
        res = dijkstra_plan_native(
            obstacle, start[0], start[1], goal[0], goal[1]
        )
        if res is None:
            return None
        xs_idx, ys_idx = res
        return (
            [self._pos(int(i)) for i in xs_idx],
            [self._pos(int(i)) for i in ys_idx],
        )
