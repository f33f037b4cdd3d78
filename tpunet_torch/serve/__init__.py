"""Disaggregated prefill/decode serving tier over the tpunet transport.

Prefill ranks run prompt ingestion and produce KV blocks; decode ranks run
the BatchServer slot machine; the blocks ship between them over the
transport's multi-stream P2P path with the block-scaled wire codec (int8 by
default; f32 makes the wire exact and the greedy output stream bitwise
equal to single-host serving).

Minimal setup::

    # decode box
    worker = serve.connect_decode("10.0.0.1:7100", model, params,
                                  slots=8, max_len=512)
    worker.serve()

    # frontend box
    pe = serve.PrefillEngine(model, params, max_len=512)
    router = serve.Router(pe)
    lsock = serve.Router.listen("0.0.0.0:7100")
    router.accept_ranks(lsock, n=1)
    rid = router.submit(prompt_tokens, max_new_tokens=64)
    tokens = router.run()[rid]

On a mesh model (``tp_axis`` set) each tier is a tp group of ranks: the
group's tp-index-0 rank (the leader) runs the calls above, the others
follow it, and the KV wire stays the single-rank tier's (whole kv heads),
so a group pairs with a single rank or another group::

    # decode group: the leader, then every other rank of its tp group
    worker = serve.connect_decode(addr, model, local, slots=8, max_len=512)
    worker.serve(); worker.close()          # close() releases followers
    serve.follow_decode(model, local, slots=8, max_len=512)

    # prefill group: the leader builds the Router; the others follow
    pe = serve.PrefillEngine(model, local, max_len=512)
    pe.follow()                             # on every rank but the leader

Live weight updates (``publish``): ``WeightPublisher(router).publish(v,
params)`` ships a new checkpoint to every decode rank over a bulk-class
tree broadcast, flips the fleet behind a fleet-wide CRC32C gate at request
boundaries, and keeps each request on the version that admitted it.

Env knobs: TPUNET_KV_WIRE_DTYPE, TPUNET_ROUTER_POLICY, TPUNET_SERVE_ROLE,
TPUNET_SWAP_TIMEOUT_MS, TPUNET_SWAP_CHUNK_BYTES, TPUNET_PUBLISH_CLASS.
"""

from tpunet_torch.serve.decode import DecodeWorker, connect as connect_decode  # noqa: F401
from tpunet_torch.serve.decode import follow_decode  # noqa: F401
from tpunet_torch.serve.kv import (  # noqa: F401
    KV_CODECS,
    decode_kv_block,
    encode_kv_block,
    kv_block_elems,
    kv_wire_bytes,
    model_signature,
)
from tpunet_torch.serve.prefill import PrefillEngine  # noqa: F401
from tpunet_torch.serve.protocol import (  # noqa: F401
    FrameLink,
    Hello,
    KVCodecMismatchError,
    KVIntegrityError,
    NoLiveDecodeRankError,
    RouterBusyError,
    ServeError,
    SwapAnnounce,
    TierMismatchError,
    TierProtocolError,
    wire_decode,
    wire_frontend,
)
from tpunet_torch.serve.publish import (  # noqa: F401
    WeightPublisher,
    WeightReceiver,
    WeightSwapError,
    flatten_params,
    parse_swap_script,
    roundtrip_params,
    swap_action,
    swap_pending,
    unflatten_params,
)
from tpunet_torch.serve.router import Router  # noqa: F401
