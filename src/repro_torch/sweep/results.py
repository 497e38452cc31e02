"""Sweep results table (PyTorch port of ``repro.sweep.results``).

The sweep returns one ``EmulatorState`` with a leading point axis; this
module reduces it to the host-side numbers a design study reads (AMAT,
fast-tier hit rate, migrations, NVM wear, held responses, faults,
energy), one row per point, and persists the rows as CSV or JSONL.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os

import numpy as np

from .. import telemetry
from ..core import table as table_lib


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class SweepResult:
    """Batched outcome of :meth:`repro_torch.Engine.sweep`.

    ``states`` / ``outs`` carry a leading point axis aligned with
    ``points``; :meth:`rows` reduces them to one summary dict per point.
    ``states`` is also the continuation handle of
    :meth:`repro_torch.Engine.continue_sweep`, which replays the recorded
    stacked ``params`` and ``registry``.
    """

    points: list
    states: object
    outs: dict
    params: object = None
    registry: object = None

    def __len__(self) -> int:
        return len(self.points)

    def rows(self) -> list[dict]:
        """One summary dict a design point, on the host."""
        with telemetry.span("sweep.rows"):
            return self._rows()

    def _rows(self) -> list[dict]:
        c = {k: _np(v) for k, v in self.states.counters._asdict().items()}
        clock = _np(self.states.clock)
        swaps = _np(self.states.dma.swaps_done)
        wear = _np(table_lib.wear(self.states.table))
        rows = []
        for i, pt in enumerate(self.points):
            fast = int(c["reads_fast"][i]) + int(c["writes_fast"][i])
            slow = int(c["reads_slow"][i]) + int(c["writes_slow"][i])
            rows.append({
                "index": pt.index,
                "label": pt.label,
                **dict(pt.coords),
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
        return rows

    def best(self, key: str = "amat_cyc") -> dict:
        """The row minimising ``key`` (AMAT by default)."""
        return min(self.rows(), key=lambda r: r[key])

    def to_csv(self, path: str | os.PathLike) -> str:
        """Write one CSV line per design point; returns the path."""
        rows = self.rows()
        with open(path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
        return str(path)

    def to_jsonl(self, path: str | os.PathLike) -> str:
        """Write one JSON object per line per design point; returns the
        path."""
        with open(path, "w") as fh:
            for row in self.rows():
                fh.write(json.dumps(row) + "\n")
        return str(path)

    def table(self, keys: tuple[str, ...] | None = None) -> str:
        """Fixed-width text table of per-point summaries."""
        rows = self.rows()
        if keys is None:
            keys = ("label", "amat_cyc", "fast_hit_rate", "swaps",
                    "nvm_peak_wear", "reorder_held", "energy_mJ",
                    "emulated_ms")

        def fmt(v):
            return f"{v:.3f}" if isinstance(v, float) else str(v)

        cells = [[fmt(r.get(k, "")) for k in keys] for r in rows]
        widths = [max(len(k), *(len(row[j]) for row in cells))
                  for j, k in enumerate(keys)]
        header = "  ".join(k.ljust(w) for k, w in zip(keys, widths))
        lines = [header, "-" * len(header)]
        lines += ["  ".join(v.rjust(w) for v, w in zip(row, widths))
                  for row in cells]
        return "\n".join(lines)


def _coerce(value: str):
    """CSV cells back to int/float where they parse (labels stay str)."""
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            continue
    return value


def load_rows(path: str | os.PathLike) -> list[dict]:
    """Read rows written by :meth:`SweepResult.to_csv` /
    :meth:`SweepResult.to_jsonl` (``.jsonl`` is JSONL, anything else CSV;
    CSV cells are coerced back to int/float where they parse)."""
    p = str(path)
    if p.endswith(".jsonl"):
        with open(p) as fh:
            return [json.loads(line) for line in fh if line.strip()]
    with open(p, newline="") as fh:
        return [{k: _coerce(v) for k, v in row.items()}
                for row in csv.DictReader(fh)]
