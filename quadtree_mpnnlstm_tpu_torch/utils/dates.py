"""Launch-date helpers (own copy of ``quadtree_mpnnlstm_tpu/utils/dates.py``).

Launch dates are nanoseconds since the epoch, as ``IceDataset`` stores
them; conversions use the local time zone, as the JAX package's do.
"""

from __future__ import annotations

import datetime

NS_PER_DAY = 8.64e13


def int_to_datetime(x) -> datetime.datetime:
    """Nanoseconds-since-epoch integer → datetime."""
    return datetime.datetime.fromtimestamp(float(x) / 1e9)


def day_of_year(launch_date_ns: int, step: int) -> int:
    """0-based day of the year of launch date + ``step`` days."""
    return int_to_datetime(launch_date_ns + NS_PER_DAY * step).timetuple().tm_yday - 1
