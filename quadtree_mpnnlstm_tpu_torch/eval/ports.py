"""Port accessibility: breakup and freezeup dates, ice-free routing (numpy).

Own copy of ``quadtree_mpnnlstm_tpu/eval/ports.py``. Around a port, the
fraction of nearby pixels with SIC above the navigability threshold (0.15)
gives per-year breakup (spring: the fraction drops below a level) and
freezeup (fall: it rises above it) dates; A* finds ice-free ship paths.
"""

from __future__ import annotations

import heapq
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

PORTS_HUDSON_BAY = {  # (lat, lon)
    "churchill": (58.875, -94.27),
    "inukjuak": (58.4514, -78.1351),
    "quaqtaq": (61.0442, -69.6421),
}

SIC_NAVIGABLE = 0.15


def ice_proportion(
    siconc: np.ndarray,
    mask: np.ndarray,
    center: Tuple[int, int],
    window: int = 5,
    thresh: float = SIC_NAVIGABLE,
) -> np.ndarray:
    """Fraction of unmasked pixels with SIC > thresh in a (2w × 2w) window
    around ``center`` per timestep."""
    t, rows, cols = siconc.shape[:3]
    i, j = center
    sl_r = slice(max(0, i - window), min(rows, i + window))
    sl_c = slice(max(0, j - window), min(cols, j + window))
    win = np.nan_to_num(siconc[:, sl_r, sl_c])
    mwin = np.asarray(mask, bool)[sl_r, sl_c]
    valid = (~mwin).sum()
    if valid == 0:
        return np.zeros(t)
    return ((win > thresh) & ~mwin).sum(axis=(1, 2)) / valid


def _first_crossing(prop, times, lo, hi, level, rising):
    sel = (times >= lo) & (times <= hi)
    idx = np.nonzero(sel)[0]
    for k in idx:
        if (prop[k] > level) if rising else (prop[k] < level):
            return times[k]
    return None


def breakup_freezeup_dates(
    proportion: np.ndarray,
    times: np.ndarray,
    years: Sequence[int],
    level: float = 0.5,
    breakup_window: Tuple[str, str] = ("-05-15", "-09-01"),
    freezeup_window: Tuple[str, str] = ("-10-01", "-12-31"),
) -> Dict[int, Dict[str, Optional[np.datetime64]]]:
    """Per-year breakup (ice fraction first drops below ``level`` in the
    spring window) and freezeup (first rises above it in the fall window)
    dates; None where no crossing falls in the window."""
    times = np.asarray(times, dtype="datetime64[D]")
    out = {}
    for year in years:
        b = _first_crossing(
            proportion, times,
            np.datetime64(f"{year}{breakup_window[0]}"),
            np.datetime64(f"{year}{breakup_window[1]}"),
            level, rising=False,
        )
        f = _first_crossing(
            proportion, times,
            np.datetime64(f"{year}{freezeup_window[0]}"),
            np.datetime64(f"{year}{freezeup_window[1]}"),
            level, rising=True,
        )
        out[year] = {"breakup": b, "freezeup": f}
    return out


def astar_path(
    blocked: np.ndarray,
    start: Tuple[int, int],
    end: Tuple[int, int],
    diagonal: bool = True,
) -> Optional[np.ndarray]:
    """Shortest path through unblocked cells (A*, Chebyshev-distance
    heuristic, ties broken by ``heapq``'s order of (f, g, cell)); returns
    an (L, 2) index array or None."""
    blocked = np.asarray(blocked, bool)
    rows, cols = blocked.shape
    if blocked[start] or blocked[end]:
        return None
    moves = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if diagonal:
        moves += [(-1, -1), (-1, 1), (1, -1), (1, 1)]

    def h(p):
        return max(abs(p[0] - end[0]), abs(p[1] - end[1]))

    open_q = [(h(start), 0.0, start)]
    came: Dict[Tuple[int, int], Tuple[int, int]] = {}
    g = {start: 0.0}
    closed = set()
    while open_q:
        _, gc, cur = heapq.heappop(open_q)
        if cur == end:
            path = [cur]
            while cur in came:
                cur = came[cur]
                path.append(cur)
            return np.array(path[::-1])
        if cur in closed:
            continue
        closed.add(cur)
        for dr, dc in moves:
            nb = (cur[0] + dr, cur[1] + dc)
            if not (0 <= nb[0] < rows and 0 <= nb[1] < cols):
                continue
            if blocked[nb] or nb in closed:
                continue
            step = 1.41421356 if dr and dc else 1.0
            ng = gc + step
            if ng < g.get(nb, np.inf):
                g[nb] = ng
                came[nb] = cur
                heapq.heappush(open_q, (ng + h(nb), ng, nb))
    return None


def route_open(
    siconc_frame: np.ndarray,
    mask: np.ndarray,
    start: Tuple[int, int],
    end: Tuple[int, int],
    thresh: float = SIC_NAVIGABLE,
):
    """Ice-free route on one SIC frame: pixels with SIC > thresh or land are
    blocked."""
    blocked = (np.nan_to_num(siconc_frame) > thresh) | np.asarray(mask, bool)
    return astar_path(blocked, start, end)
