"""Elastic recovery: rebuild the communicator around a replacement rank.

The port of ``tpunet/train/elastic.py``. Peer death already surfaces as a
typed ``NativeError`` on every surviving rank; this module adds the
recovery: survivors and a respawned replacement agree on a new
*generation*, re-run rendezvous on a generation-derived coordinator port,
and resume training from the latest checkpoint.

Protocol (no side channel beyond the shared checkpoint/rendezvous dir that
an elastic deployment already has):

1. Generation g trains on coordinator ``host:(port+g)``.
2. A rank dies. Every survivor's next collective raises a typed comm error
   (the transport's keepalive/poisoning guarantees this: no hangs).
3. Survivors: ``finalize()``, bump g, publish it to ``<dir>/GENERATION``
   (atomic rename; last writer wins with the same value), rebuild at the new
   port. The bootstrap blocks until all ``world_size`` ranks arrive.
4. The replacement process (respawned by the job scheduler or supervisor)
   reads ``GENERATION`` and joins. If it raced ahead of the survivors'
   bump it fails rendezvous after TPUNET_BOOTSTRAP_TIMEOUT_MS, re-reads,
   and retries: convergence needs no ordering between respawn and bump.
5. Everyone restores the latest checkpoint and continues; the checkpoint
   layer restores bitwise, so a crashed step is replayed, not lost.

With ``allow_shrink=True`` steps 3-4 change policy: instead of waiting for
a replacement, survivors seal a smaller membership after a grace window and
continue at world-1 with re-assigned ranks (see _shrink_rendezvous).

The train callback owns the step loop so it can checkpoint at its own
cadence; ``run_elastic`` owns failure classification and the rebuild loop.
Before a rebuild it collects the failed generation's garbage: the
exception's frames hold that generation's parameters, optimizer state and
gradients (on the card, gigabytes), and they must be gone before the next
generation builds and restores its own.
"""

from __future__ import annotations

import gc
import json
import os
import time
from pathlib import Path
from typing import Any, Callable

from tpunet_torch import distributed
from tpunet_torch._native import NativeError
from tpunet_torch.collectives import Communicator

GENERATION_FILE = "GENERATION"


def read_generation(directory: str | Path) -> int:
    """Current generation published in `directory` (0 if never written)."""
    try:
        return int((Path(directory) / GENERATION_FILE).read_text().strip())
    except (FileNotFoundError, ValueError):
        return 0


def write_generation(directory: str | Path, generation: int) -> None:
    """Atomically publish `generation` (rename; concurrent writers of the
    same value — every survivor — are idempotent)."""
    path = Path(directory) / GENERATION_FILE
    tmp = path.with_name(f".{GENERATION_FILE}.{os.getpid()}.tmp")
    tmp.write_text(f"{generation}\n")
    os.replace(tmp, path)


def is_comm_failure(exc: BaseException) -> bool:
    """True when `exc` means the communicator (not the training math) broke:
    a NativeError from the transport/collectives, or a wrapper carrying one
    in its message or EXPLICIT cause chain (``raise X from err`` sets
    __cause__). Implicit __context__ is deliberately NOT walked:
    an unrelated error raised while handling a comm error (say, a NaN-loss
    ValueError inside an except block) must still propagate, not be
    "recovered" into silent restarts.

    The typed failure-model errors are NativeError subclasses and classify
    accordingly: a ProgressTimeoutError (TPUNET_PROGRESS_TIMEOUT_MS — peer
    alive but stuck) triggers the SAME generation rebuild as a dead peer,
    and a CorruptionError (CRC32C mismatch under TPUNET_CRC=1) rebuilds
    rather than silently reducing damaged gradients. The port's collectives
    (``interop``'s staged and bucketed all-reduces) raise the native error
    itself, never a wrapper."""
    seen: set[int] = set()
    cur: BaseException | None = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, NativeError):
            return True
        if "tpunet native" in str(cur):
            return True
        cur = cur.__cause__
    return False


def generation_coordinator(coordinator: str, generation: int) -> str:
    host, port = coordinator.rsplit(":", 1)
    return f"{host}:{int(port) + generation}"


class ExcludedFromMembership(RuntimeError):
    """This process missed a shrink's grace window (or joined after the
    membership doc was sealed) and is no longer part of the job."""


def membership_rendezvous(directory: Path, generation: int, member_id: int,
                          advertise_host: str, base_port: int,
                          grace_s: float) -> tuple[str, int, int, list[int]]:
    """Agree on `generation`'s membership and return
    (coordinator, new_rank, new_world, members).

    Every participant — survivor OR joiner; the protocol cannot tell them
    apart, which is exactly what makes the same window serve both shrink
    and grow (tpunet_torch.elastic.ElasticWorld) — writes a member file naming
    its advertise host, then the LEADER — lowest member id present after
    the grace window — seals ``MEMBERS.json`` exactly once (O_EXCL: a late
    lower id that lost the race adopts the sealed doc rather than
    rewriting membership under peers already rendezvousing). Member ids
    are the caller's stable ids, not per-generation ranks; new ranks are
    the sealed members' sort order. Participants absent from the sealed
    doc raise ExcludedFromMembership — the grace window IS the membership
    contract.
    """
    gdir = directory / f"g{generation}"
    gdir.mkdir(parents=True, exist_ok=True)
    # Atomic publish (tmp + replace): the sealing leader reads these files
    # the moment they appear in its glob, and a torn/empty advertise host
    # would be sealed into an immutable doc as a broken coordinator. The
    # dot-prefixed tmp never matches the member_* glob.
    tmp = gdir / f".member_{member_id}.{os.getpid()}.tmp"
    tmp.write_text(advertise_host)
    os.replace(tmp, gdir / f"member_{member_id}")
    doc_path = gdir / "MEMBERS.json"

    def members_present() -> list[int]:
        return sorted(int(p.name.split("_", 1)[1]) for p in gdir.glob("member_*"))

    deadline = time.monotonic() + grace_s
    while not doc_path.exists():
        present = members_present()
        if present and present[0] == member_id and time.monotonic() >= deadline:
            # Leader after a full grace window: seal what arrived.
            sealed = {
                "members": present,
                "hosts": {str(m): (gdir / f"member_{m}").read_text()
                          for m in present},
            }
            tmp = gdir / f".members.{os.getpid()}.tmp"
            tmp.write_text(json.dumps(sealed))
            try:
                # Atomic exclusive publish of a COMPLETE file: link() fails
                # with EEXIST if another leader sealed first (no TOCTOU, no
                # torn reads) — the loser adopts the sealed doc below.
                os.link(tmp, doc_path)
            except FileExistsError:
                pass
            finally:
                tmp.unlink(missing_ok=True)
            break
        if time.monotonic() > deadline + 4 * grace_s:
            raise RuntimeError(
                f"shrink membership for generation {generation} never sealed "
                f"(leader {present[0] if present else '?'} missing?)"
            )
        time.sleep(0.1)

    doc = json.loads(doc_path.read_text())
    members: list[int] = doc["members"]
    if member_id not in members:
        raise ExcludedFromMembership(
            f"member {member_id} missed generation {generation}'s grace window "
            f"(sealed members: {members})"
        )
    new_rank = members.index(member_id)
    coordinator = f"{doc['hosts'][str(members[0])]}:{base_port + generation}"
    return coordinator, new_rank, len(members), members


def _shrink_rendezvous(directory: Path, generation: int, member_id: int,
                       advertise_host: str, base_port: int,
                       grace_s: float) -> tuple[str, int, int]:
    """run_elastic's 3-tuple view of membership_rendezvous (shrink policy
    never needs the member list)."""
    coordinator, new_rank, new_world, _ = membership_rendezvous(
        directory, generation, member_id, advertise_host, base_port, grace_s)
    return coordinator, new_rank, new_world


def run_elastic(
    train_once: Callable[[Communicator, int], Any],
    *,
    coordinator: str,
    rank: int,
    world_size: int,
    directory: str | Path,
    max_restarts: int = 2,
    generation: int | None = None,
    rejoin_delay_s: float = 0.5,
    join_timeout_s: float = 600.0,
    allow_shrink: bool = False,
    shrink_grace_s: float = 10.0,
    min_world: int = 1,
    advertise_host: str | None = None,
) -> Any:
    """Run ``train_once(comm, generation)`` under elastic recovery.

    Returns train_once's return value. Comm failures during TRAINING trigger
    rebuild (up to ``max_restarts`` across the job's life in this process);
    any other exception propagates immediately — a loss blowup must not be
    "recovered" into silent data loss.

    Rendezvous failures spend wall-clock, not restarts: the process re-reads
    the published generation and retries until ``join_timeout_s`` elapses
    without a successful join. Only processes that HELD a live communicator
    bump and publish the generation (monotonically); a joiner that cannot
    rendezvous never publishes — a replacement racing ahead of the
    survivors' bump would otherwise publish generations nobody listens on
    and strand the job.

    ``generation=None`` starts from the published generation — what a
    respawned replacement wants; survivors carry their generation forward
    in-process.

    ``allow_shrink=True`` switches recovery policy from
    wait-for-a-replacement to CONTINUE WITHOUT THE DEAD RANK: survivors run
    a grace-window membership rendezvous through the shared directory (see
    _shrink_rendezvous) and rebuild with re-assigned ranks, a smaller world,
    and a coordinator re-elected onto the lowest surviving member's
    ``advertise_host`` (so losing rank 0's host is survivable — which is why
    multi-host callers MUST pass their own reachable address; only loopback
    setups may omit it). ``rank`` doubles as the stable member id.
    ``train_once`` must read its rank/world from the comm, not the closure.
    Shrinking below ``min_world`` raises instead of limping on.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    g = read_generation(directory) if generation is None else generation
    member_id = rank
    cur_coordinator = generation_coordinator(coordinator, g)
    cur_rank, cur_world = rank, world_size
    base_host, base_port = coordinator.rsplit(":", 1)
    if allow_shrink and advertise_host is None:
        # No safe multi-host default exists: advertising the ORIGINAL
        # coordinator's host would re-elect the new coordinator onto the
        # very machine whose death we are shrinking around. Loopback dev
        # setups are unambiguous; everyone else must say who they are.
        if base_host in ("127.0.0.1", "localhost", "::1"):
            advertise_host = base_host
        else:
            raise ValueError(
                "allow_shrink=True on a non-loopback coordinator requires "
                "advertise_host=<this machine's reachable address> — the "
                "re-elected coordinator binds on a surviving member's host"
            )
    restarts = 0
    ever_joined = False
    join_deadline = time.monotonic() + join_timeout_s

    while True:
        if restarts or ever_joined:
            # The failed attempt's exception is gone; its frames (and the
            # tensors they hold) may sit in reference cycles until collected.
            gc.collect()
        comm = None
        try:
            distributed.finalize()  # no-op unless a previous comm is live
            comm = distributed.initialize(cur_coordinator, cur_rank, cur_world)
            ever_joined = True
            join_deadline = time.monotonic() + join_timeout_s
            return train_once(comm, g)
        except Exception as exc:  # noqa: BLE001 — classified below
            if not is_comm_failure(exc):
                raise
            distributed.finalize()
            if comm is None:
                # Rendezvous failed. Never burn a restart here; bound by
                # wall-clock instead.
                if time.monotonic() > join_deadline:
                    raise
                g = max(g, read_generation(directory))
                if not allow_shrink:
                    # Replacement policy: adopt the published generation and
                    # retry — the survivors' bump is what we're chasing.
                    cur_coordinator = generation_coordinator(coordinator, g)
                elif ever_joined:
                    # Shrink policy, and this process WAS part of a running
                    # job: a sealed generation that cannot assemble means a
                    # member died between seal and rebuild. There is no
                    # replacement to wait for — advance and re-run
                    # membership without it. (Before the first successful
                    # join, fall through and just retry: sealing at startup
                    # could permanently exclude a healthy-but-slow rank.)
                    g = max(g + 1, read_generation(directory))
                    write_generation(directory, g)
                    cur_coordinator, cur_rank, cur_world = _shrink_rendezvous(
                        directory, g, member_id, advertise_host,
                        int(base_port), shrink_grace_s,
                    )
                    if cur_world < min_world:
                        raise RuntimeError(
                            f"membership shrank to {cur_world} < min_world "
                            f"{min_world}"
                        )
            else:
                restarts += 1
                if restarts > max_restarts:
                    raise
                # Sole publishers are ranks that lost a LIVE communicator;
                # they agree on the increment, and max() keeps the published
                # value monotonic even across overlapping failures.
                g = max(g + 1, read_generation(directory))
                write_generation(directory, g)
                if allow_shrink:
                    cur_coordinator, cur_rank, cur_world = _shrink_rendezvous(
                        directory, g, member_id, advertise_host,
                        int(base_port), shrink_grace_s,
                    )
                    if cur_world < min_world:
                        raise RuntimeError(
                            f"membership shrank to {cur_world} < min_world "
                            f"{min_world}"
                        )
                else:
                    cur_coordinator = generation_coordinator(coordinator, g)
                # A fresh rebuild opens a fresh join window — without this, a
                # failure arriving join_timeout_s after the last successful
                # join would start the rendezvous retries already expired.
                join_deadline = time.monotonic() + join_timeout_s
            time.sleep(rejoin_delay_s)
