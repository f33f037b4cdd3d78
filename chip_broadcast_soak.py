"""Soak the tpunet broadcast under the armed QoS wire window on the GPU host.

    python3 chip_broadcast_soak.py [--tries N] [--mib M] [--casts K]

Two ranks spawned on this host, with the QoS gate armed as the swap phase
of chip_smoke.py arms it (TPUNET_QOS_INFLIGHT_BYTES=wire=256K,
TPUNET_QOS_WEIGHTS=latency=8,bulk=1), two data streams
(TPUNET_NSTREAMS=2) and the progress watchdog at 10 s
(TPUNET_PROGRESS_TIMEOUT_MS=10000). Each try wires a fresh bulk-class
tree communicator and runs K broadcasts of M MiB from rank 0, one call
each: first plain ``Communicator.broadcast`` of host bytes, then
``interop.dcn_broadcast`` of a tensor on the card (staged through pinned
host memory). A try passes when every broadcast arrives bitwise; a stall
surfaces as the watchdog's typed error (ROADMAP C.12). Prints one JSON line a try and a
last line with the counts and the card's name and power limit; exits
non-zero without a GPU or when a try
failed.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import traceback

ENV = {"TPUNET_QOS_INFLIGHT_BYTES": "wire=256K",
       "TPUNET_QOS_WEIGHTS": "latency=8,bulk=1", "TPUNET_NSTREAMS": "2",
       "TPUNET_PROGRESS_TIMEOUT_MS": "10000"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, ports: list, nbytes: int, casts: int, q) -> None:
    """Every try on this rank: {try: {kind: (ok, seconds) or error}}."""
    os.environ.update(ENV)
    try:
        import numpy as np
        import torch

        from tpunet_torch import distributed, interop
        from tpunet_torch.collectives import Communicator

        wire = np.random.default_rng(0).integers(0, 256, nbytes, np.uint8)
        dev = torch.from_numpy(wire).cuda()
        out = []
        for a, b in ports:
            res = {}
            try:
                with Communicator(f"127.0.0.1:{a}", rank, 2,
                                  wire_dtype="f32", algo="tree",
                                  traffic_class="bulk") as comm:
                    t0 = time.perf_counter()
                    ok = True
                    for _ in range(casts):
                        buf = wire.copy() if rank == 0 else np.zeros_like(
                            wire)
                        comm.broadcast(buf, root=0, out=buf)
                        ok &= buf.tobytes() == wire.tobytes()
                    res["host"] = (ok, time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — reported per try
                res["host"] = repr(e)
            try:
                distributed.initialize(f"127.0.0.1:{b}", rank, 2,
                                       wire_dtype="f32", algo="tree",
                                       traffic_class="bulk")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ok = True
                for _ in range(casts):
                    x = dev.clone() if rank == 0 else torch.zeros_like(dev)
                    ok &= bool(torch.equal(interop.dcn_broadcast(x, 0), dev))
                res["card"] = (ok, time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — reported per try
                res["card"] = repr(e)
            finally:
                distributed.finalize()
            out.append(res)
        q.put((rank, "OK", out))
    except Exception:  # noqa: BLE001 — reported to the parent
        q.put((rank, "FAIL", traceback.format_exc()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tries", type=int, default=20)
    ap.add_argument("--mib", type=int, default=8)
    ap.add_argument("--casts", type=int, default=5)
    args = ap.parse_args()
    import multiprocessing as mp

    import torch

    if not torch.cuda.is_available():
        print("chip_broadcast_soak: no CUDA device", file=sys.stderr)
        return 2
    import tpunet_torch  # noqa: F401  (fails outside a checkout)

    nbytes = args.mib << 20
    ports = [(_free_port(), _free_port()) for _ in range(args.tries)]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, ports, nbytes, args.casts,
                                             q)) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    res = {}
    try:
        for _ in procs:
            rank, status, payload = q.get(timeout=60 * args.tries)
            if status != "OK":
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            res[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    passed = {"host": 0, "card": 0}
    for t in range(args.tries):
        row = {"try": t}
        for kind in passed:
            got = [res[r][t][kind] for r in range(2)]
            ok = all(isinstance(g, tuple) and g[0] for g in got)
            passed[kind] += ok
            row[kind] = dict(ok=ok, seconds=[g[1] if isinstance(g, tuple)
                                             else g for g in got],
                             gb_per_s=args.casts * nbytes / 1e9 / max(
                                 g[1] for g in got) if ok else None)
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"tries": args.tries, "mib": args.mib,
                      "casts": args.casts, "passed": passed, "env": ENV,
                      "wall_s": time.perf_counter() - t0,
                      "card": card.strip()}), flush=True)
    return 0 if all(v == args.tries for v in passed.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
