"""Blockwise (memory-fused) softmax cross-entropy over a large vocabulary.

The port of ``tpunet/ops/fused_xent.py``: the lm head and the
cross-entropy of a 32k-vocab model computed with only ONE vocab block of
logits live at a time, by a loop over vocab blocks carrying an online
logsumexp. Each block body runs under ``torch.utils.checkpoint``
(non-reentrant), so the backward recomputes that block's logits from
(feats, weights) instead of keeping them: the (N, V) logits never exist.
There is no kernel here: the JAX version is an XLA scan, not Pallas, and
each block is one matrix product.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _block(feats, w, dtype, labels, start: int, run_max, run_sum,
           label_logit):
    """One vocab block: fold its logits into the running (max, sum,
    label logit). feats is f32; w is rounded to `dtype`, then the product
    accumulates in f32."""
    logits = feats @ w.to(dtype).float()
    width = logits.shape[1]
    new_max = torch.maximum(run_max, logits.amax(dim=-1))
    run_sum = run_sum * torch.exp(run_max - new_max) + torch.exp(
        logits - new_max[:, None]).sum(dim=-1)
    local = labels - start
    hit = (local >= 0) & (local < width)
    picked = logits.gather(1, local.clamp(0, width - 1)[:, None])[:, 0]
    label_logit = label_logit + torch.where(hit, picked, 0.0)
    return new_max, run_sum, label_logit


def blockwise_cross_entropy(feats, kernel, labels, block_vocab: int = 8192,
                            return_lse: bool = False):
    """Exact per-token negative log-likelihood without full logits.

    feats: (N, d) floating (bf16/f32), the final hidden states.
    kernel: (d, V) lm-head weights, the JAX layout (pass the port's
        ``lm_head.weight.t()``, a view). Cast to feats' dtype, then the
        product runs on f32 copies of both, which is exact for bf16 inputs:
        the counterpart of ``preferred_element_type=float32``.
    labels: (N,) integer; negatives wrap python-style (-1 == V-1) and
        labels >= V give NaN, matching optax exactly.
    Returns (N,) f32 losses logsumexp(logits) - logits[label]; with
    return_lse=True, (losses, lse).
    """
    n_tokens, d = feats.shape
    vocab = kernel.shape[1]
    if tuple(labels.shape) != (n_tokens,):
        raise ValueError(f"labels shape {tuple(labels.shape)} != "
                         f"({n_tokens},)")
    labels = labels.long()
    labels = torch.where(labels < 0, labels + vocab, labels)
    valid = (labels >= 0) & (labels < vocab)
    block_vocab = min(block_vocab, vocab)
    feats32 = feats.float()
    dev = feats.device
    run_max = torch.full((n_tokens,), float("-inf"), device=dev)
    run_sum = torch.zeros((n_tokens,), device=dev)
    label_logit = torch.zeros((n_tokens,), device=dev)
    for start in range(0, vocab, block_vocab):
        # The JAX scan pads the last block with -inf columns; slicing it
        # short gives the same sums.
        run_max, run_sum, label_logit = checkpoint(
            _block, feats32, kernel[:, start:start + block_vocab],
            feats.dtype, labels, start, run_max, run_sum, label_logit,
            use_reentrant=False)
    label_logit = torch.where(valid, label_logit, float("nan"))
    lse = run_max + torch.log(run_sum)
    return (lse - label_logit, lse) if return_lse else lse - label_logit
