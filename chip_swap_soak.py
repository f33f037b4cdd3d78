"""Repeat chip_smoke.py's live weight swap phase on one NVIDIA GPU.

    python3 chip_swap_soak.py [--runs N] [--checkout DIR] [--no-qos-window]
                              [--out DIR]

Builds the kernels, makes the serve phase's checkpoint from seed 0, then
runs chip_smoke.py's ``phase_swap`` N times: a frontend and two decode
ranks spawned on the card, a corrupt receiver refused fleet-wide, a rank
killed mid-broadcast, respawned stale and caught up (see chip_smoke.py's
docstring). Each run prints one JSON line: whether every gate passed (else
the end of the error), and for the first two windows the publication
counts, the phase times, the broadcast rate and the catch-up time.
``--checkout`` imports chip_smoke and tpunet_torch from another checkout
(a parent commit, to compare it with this one). ``--no-qos-window`` drops
the QoS wire window the phase arms (TPUNET_QOS_INFLIGHT_BYTES). Every
process dumps its flight recorder under ``--out``/<pid> on a native
watchdog verdict or a swap abort; the last line counts the runs that
passed and gives, for each watchdog dump, its longest QoS queue wait and
its longest gap between two events. Exits non-zero without a GPU or when
a run failed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def _setup() -> None:
    """Point this process (the parent, and each spawned rank when it
    imports this module) at the chosen checkout, its flight-recorder
    directory and the chosen QoS window."""
    root = os.environ.get("SWAP_SOAK_CHECKOUT")
    if root and root not in sys.path:
        sys.path.insert(0, root)
    out = os.environ.get("SWAP_SOAK_OUT")
    if out:
        os.environ["TPUNET_FLIGHTREC_DIR"] = os.path.join(out,
                                                          str(os.getpid()))
        os.makedirs(os.environ["TPUNET_FLIGHTREC_DIR"], exist_ok=True)
    if os.environ.get("SWAP_SOAK_NO_QOS_WINDOW"):
        import chip_smoke

        chip_smoke.SWAP_ENV.pop("TPUNET_QOS_INFLIGHT_BYTES", None)


def _dumps(out: str) -> list[dict]:
    """Each watchdog dump under `out`: its process, its longest QoS queue
    wait and its longest gap between two consecutive events."""
    rows = []
    for path in sorted(glob.glob(os.path.join(out, "*", "*.json"))):
        with open(path) as f:
            dump = json.load(f)
        if dump.get("reason") != "watchdog":
            continue
        ev = dump["events"]
        waits = [e["b"] for e in ev if e["kind"] == "qos_wait"]
        gaps = [b["t"] - a["t"] for a, b in zip(ev, ev[1:])]
        rows.append({"pid": os.path.basename(os.path.dirname(path)),
                     "max_qos_wait_us": max(waits, default=None),
                     "max_event_gap_us": max(gaps, default=None)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--checkout", default=None)
    ap.add_argument("--no-qos-window", action="store_true")
    ap.add_argument("--out", default="build/swap_soak")
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    os.environ["SWAP_SOAK_OUT"] = out
    if args.checkout:
        os.environ["SWAP_SOAK_CHECKOUT"] = os.path.abspath(args.checkout)
    if args.no_qos_window:
        os.environ["SWAP_SOAK_NO_QOS_WINDOW"] = "1"
    _setup()
    import torch

    if not torch.cuda.is_available():
        print("chip_swap_soak: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_card()
    cs.phase_build()
    params = cs.phase_model(0)
    logged, log = [], cs.log

    def keep(phase, **fields):
        if phase == "swap":
            logged.append(fields)
        log(phase, **fields)

    cs.log = keep
    passed = 0
    for i in range(args.runs):
        t0, err = time.perf_counter(), None
        try:
            cs.phase_swap(0, params)
            passed += 1
        except Exception as e:  # noqa: BLE001 — reported per run
            err = str(e)[-600:]
        row = {"run": i, "ok": err is None,
               "wall_s": time.perf_counter() - t0}
        if logged:
            row["windows"] = [
                {k: w.get(k) for k in ("pub_stats", "phases_count_s",
                                       "broadcast_gb_per_s", "publish_s",
                                       "catch_up_s")}
                for w in logged[-1]["windows"][:2]]
        if err:
            row["error"] = err
        logged.clear()
        print("soak " + json.dumps(row), flush=True)
    print(json.dumps({"checkout": args.checkout or ".",
                      "qos_window": not args.no_qos_window,
                      "runs": args.runs, "passed": passed,
                      "watchdog_dumps": _dumps(out)}), flush=True)
    return 0 if passed == args.runs else 1


if __name__ == "__main__":
    sys.exit(main())
else:
    _setup()
