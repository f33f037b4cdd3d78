"""Serving-tier configuration read from the environment.

Only the knobs the port's serving path reads, with the same names and
defaults as the JAX package's ``Config``:

  TPUNET_KV_WIRE_DTYPE     KV-block wire codec: int8 (default), bf16, f32
  TPUNET_ROUTER_POLICY     least_loaded (default) or round_robin
  TPUNET_SERVE_ROLE        pin this process to "frontend" or "decode"
  TPUNET_READMIT_PROBE_MS  re-admission probe interval, default 500
"""

from __future__ import annotations

import os
from dataclasses import dataclass


def _env_choice(name: str, fallback: str, choices: tuple[str, ...],
                what: str) -> str:
    """An enumerated env var; a value outside `choices` raises ValueError
    naming the var (a typo'd codec must not silently run uncompressed)."""
    v = os.environ.get(name)
    if v is None or v == "":
        return fallback
    if v not in choices:
        raise ValueError(f"{name}={v} is invalid: {what} must be one of "
                         f"{', '.join(choices)}")
    return v


def _env_int_checked(name: str, fallback: int, minimum: int,
                     what: str) -> int:
    """A numeric env var; a number below `minimum` raises ValueError,
    non-numeric garbage falls back (the native reader's semantics)."""
    v = os.environ.get(name)
    if v is None or v == "":
        return fallback
    try:
        n = int(v)
    except ValueError:
        return fallback
    if n < minimum:
        raise ValueError(f"{name}={v} is invalid: {what} must be >= {minimum}")
    return n


@dataclass(frozen=True)
class Config:
    kv_wire_dtype: str = "int8"
    router_policy: str = "least_loaded"
    serve_role: str = ""
    readmit_probe_ms: int = 500

    @staticmethod
    def from_env() -> "Config":
        return Config(
            kv_wire_dtype=_env_choice(
                "TPUNET_KV_WIRE_DTYPE", "int8", ("f32", "bf16", "int8"),
                "KV-block wire codec"),
            router_policy=_env_choice(
                "TPUNET_ROUTER_POLICY", "least_loaded",
                ("least_loaded", "round_robin"), "router placement policy"),
            serve_role=_env_choice(
                "TPUNET_SERVE_ROLE", "", ("", "frontend", "decode"),
                "serving-tier role"),
            readmit_probe_ms=_env_int_checked(
                "TPUNET_READMIT_PROBE_MS", 500, 1,
                "re-admission probe interval"),
        )
