"""What a user reads of an answer, worked out from the final states: the
counter summary of one run, or one row a design point of a sweep."""
from __future__ import annotations

from . import table as table_lib
from .counters import Counters


def summary(c: Counters) -> dict:
    """Host-side readable summary of one point's counters (0-dim)."""
    g = lambda x: x.item() if hasattr(x, "item") else x
    n_reads = max(1, g(c.n_reads))
    return {
        "reads_fast": g(c.reads_fast), "writes_fast": g(c.writes_fast),
        "reads_slow": g(c.reads_slow), "writes_slow": g(c.writes_slow),
        "GB_read": (g(c.bytes_read_fast) + g(c.bytes_read_slow)) / 1e9,
        "GB_written": (g(c.bytes_write_fast) + g(c.bytes_write_slow)) / 1e9,
        "mean_read_latency_cyc": g(c.sum_read_latency) / n_reads,
        "max_latency_cyc": g(c.max_latency),
        "reorder_held": g(c.reorder_held),
        "energy_mJ": g(c.energy_pj) / 1e9,
        "poison_faults": g(c.poison_faults),
        "frames_retired": g(c.frames_retired),
        "transient_faults": g(c.transient_faults),
    }


def rows(points: list[tuple[tuple, object]], states) -> list[dict]:
    """One summary dict a design point of stacked ``states``, labelled by
    its grid coordinates."""
    np_ = lambda x: x.detach().cpu().numpy()
    c = {k: np_(v) for k, v in states.counters._asdict().items()}
    clock = np_(states.clock)
    swaps = np_(states.dma.swaps_done)
    wear = np_(table_lib.wear(states.table))
    out = []
    for i, (coords, _) in enumerate(points):
        fast = int(c["reads_fast"][i]) + int(c["writes_fast"][i])
        slow = int(c["reads_slow"][i]) + int(c["writes_slow"][i])
        out.append({
            "index": i,
            "label": "/".join(f"{k}={v}" for k, v in coords),
            **dict(coords),
            "amat_cyc": float(c["sum_read_latency"][i])
            / max(1, int(c["n_reads"][i])),
            "fast_hit_rate": fast / max(1, fast + slow),
            "swaps": int(swaps[i]),
            "nvm_peak_wear": int(wear[i].max()),
            "nvm_total_writes": int(wear[i].sum()),
            "reorder_held": int(c["reorder_held"][i]),
            "poison_faults": int(c["poison_faults"][i]),
            "frames_retired": int(c["frames_retired"][i]),
            "transient_faults": int(c["transient_faults"][i]),
            "max_latency_cyc": int(c["max_latency"][i]),
            "energy_mJ": float(c["energy_pj"][i]) / 1e9,
            "emulated_ms": int(clock[i]) / 1e6,
        })
    return out
