"""Split the columnar front door's host time by part on the door storm.

Runs ``testing/door_storm.py``'s storm (the one ``chip_smoke.py``'s door
phase runs: config #4's 10,240 docs from 10 TCP clients, 24 waves, the
storm bench's door settings) against a door whose drain pass, window
carving and ack fan are timed part by part on the host clock
(``time.perf_counter`` around each call: the frame scan, the table
parse, the record gather, the hot-doc sketch, the whole per-session
decode, the whole drain pass, the window carving, the ack fan). The
door's stage timeline (``opsd.latency_breakdown``) attributes a
window's latency to stages; this splits the drain pass inside its
decode stage, which the timeline does not. Prints one JSON line:
seconds and calls by part, the storm's wall and ops/s, and the device.

Usage: ``python3 fluidframework_tpu_torch/testing/door_drain_split.py
[--device cuda]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from fluidframework_tpu_torch.server import columnar_ingress as ci  # noqa: E402
from fluidframework_tpu_torch.server import native_ingress  # noqa: E402
from fluidframework_tpu_torch.testing import door_storm as ds  # noqa: E402

#: (owner, attribute, part name) of every timed call
PARTS = [(ci, "split_frames", "frame_scan"),
         (ci, "parse_op_tables", "table_parse"),
         (native_ingress, "gather", "record_gather"),
         (ci.ColumnarAlfred, "_note_hotdocs", "hotdoc_sketch"),
         (ci.ColumnarAlfred, "_decode_runs", "decode_runs"),
         (ci.ColumnarAlfred, "_drain", "drain_pass"),
         (ci.ColumnarAlfred, "_build_windows", "window_carving"),
         (ci.ColumnarAlfred, "_fan_acks", "ack_fan")]


def timed_parts():
    """Wrap every part in PARTS with a host-clock accumulator. Returns
    (totals {part: [seconds, calls]}, restore())."""
    totals = {name: [0.0, 0] for *_, name in PARTS}
    saved = []
    for owner, attr, name in PARTS:
        fn = getattr(owner, attr)

        def timed(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc = totals[_name]
                acc[0] += time.perf_counter() - t0
                acc[1] += 1
        saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def restore():
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return totals, restore


DOCS, CLIENTS, WAVES = 10_240, 10, 24


def run(device: str) -> dict:
    import torch
    if device == "cuda":
        from fluidframework_tpu_torch.ops import cuda_build
        cuda_build.build_all()
    eng = ds.storm_engine(DOCS, device)
    totals, restore = timed_parts()
    door = ds.open_door(eng)
    try:
        _, wall = ds.storm(door, CLIENTS, WAVES)
    finally:
        door.stop()
        restore()
    n_ops = DOCS * WAVES
    return {"device": torch.cuda.get_device_name(0) if device == "cuda"
            else "cpu", "docs": DOCS, "clients": CLIENTS, "waves": WAVES,
            "ops": n_ops, "wall_s": wall, "ops_per_s": n_ops / wall,
            "windows": door.windows_flushed, "drain": door.drain_stats(),
            "parts_s": {k: v[0] for k, v in totals.items()},
            "calls": {k: v[1] for k, v in totals.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
