"""Wire codecs for the resident flat buffer (port of
`repro/compress/codecs.py`).

A codec turns the stacked (m, d) outgoing rows into a *payload* — what
crosses the wire in a directed push — and back:

    encode(rows, key) -> Payload      decode(payload, d) -> rows
    residual(rows, payload) -> rows - decode(payload)
    row_bytes(d) -> int               (wire bytes per client push, incl. mu)

- `identity` — uncompressed f32 rows; `exact`, so every integration point
  runs the plain mix on the original buffer.
- `topk` / `randk` — K = max(1, int(d * ratio)) (column, value) pairs per
  row, columns as uint16 when d fits (`index_dtype`).
- `qsgd` — per-row linf scale and `bits` in {4, 8} stochastic rounding;
  4-bit payloads are nibble-packed into uint8.

`key` is what a randomized codec draws from: None, a `torch.Generator` on
the rows' device, or the draws themselves — (m, K) column ids for randk,
(m, d) uniforms in [0, 1) for qsgd — so a test can feed the reference's
`jax.random` draws.  `draws` says whether a codec reads its key at all.
The sparsifiers' residual zeroes the kept entries by a scatter, never a
dense decode.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Union

import torch

from ..kernels import ref

Key = Union[None, torch.Generator, torch.Tensor]


class Payload(NamedTuple):
    """What one push ships, stacked over clients.

    values:  (m, K) f32 for sparsifiers; (m, d) f32 identity; (m, d) int8
             or (m, ceil(d/2)) uint8 for qsgd.
    indices: (m, K) uint16/int32 column ids (sparsifiers only).
    scale:   (m, 1) f32 per-row quantization scale (qsgd only).
    """
    values: torch.Tensor
    indices: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None


MU_BYTES = 4          # the push-sum weight rides every payload, f32


def index_dtype(d: int) -> torch.dtype:
    """Wire dtype of sparse column ids: uint16 covers d <= 65535; int32
    beyond."""
    return torch.uint16 if d <= 0xFFFF else torch.int32


def _index_bytes(d: int) -> int:
    return 2 if d <= 0xFFFF else 4


def _draws(key: Key, shape, device, what: str) -> torch.Tensor:
    """The key's draws: a tensor key is checked and returned, a generator
    draws uniforms of `shape` on `device`."""
    if isinstance(key, torch.Tensor):
        if tuple(key.shape) != tuple(shape):
            raise ValueError(f"{what} draws of shape {tuple(key.shape)}; "
                             f"want {tuple(shape)}")
        return key.to(device)
    return torch.rand(shape, generator=key, device=device)


# ---------------------------------------------------------------------------
# identity
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class IdentityCodec:
    """Uncompressed wire format — the parity anchor: `exact` makes every
    integration point skip the error-feedback arithmetic."""
    seed: int = 0
    exact = True
    draws = False

    def encode(self, rows: torch.Tensor, key: Key = None) -> Payload:
        del key
        return Payload(rows)

    def decode(self, payload: Payload, d: int) -> torch.Tensor:
        del d
        return payload.values

    def residual(self, rows: torch.Tensor,
                 payload: Payload) -> torch.Tensor:
        del payload
        return torch.zeros_like(rows, dtype=torch.float32)

    def row_bytes(self, d: int) -> int:
        return 4 * d + MU_BYTES


# ---------------------------------------------------------------------------
# sparsification: topk / randk
# ---------------------------------------------------------------------------
def _scatter_zero(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    return torch.scatter(x.to(torch.float32), 1, indices.long(), 0.0)


@dataclasses.dataclass(frozen=True)
class _SparseCodec:
    ratio: float = 1.0 / 16.0
    seed: int = 0
    exact = False

    def __post_init__(self) -> None:
        if not 0.0 < self.ratio <= 1.0:
            raise ValueError(f"sparsifier ratio must be in (0, 1], got "
                             f"{self.ratio}")

    def k_of(self, d: int) -> int:
        return max(1, int(d * self.ratio))

    def decode(self, payload: Payload, d: int) -> torch.Tensor:
        return ref.decode_sparse(payload.values, payload.indices, d)

    def residual(self, rows: torch.Tensor,
                 payload: Payload) -> torch.Tensor:
        """x - decode(encode(x)) without the dense decode: the kept entries
        carry their exact values (distinct columns), so the residual is x
        with those entries zeroed."""
        return _scatter_zero(rows, payload.indices)

    def row_bytes(self, d: int) -> int:
        return self.k_of(d) * (4 + _index_bytes(d)) + MU_BYTES

    def _payload(self, x: torch.Tensor, cols: torch.Tensor) -> Payload:
        cols = cols.long()
        return Payload(torch.gather(x, 1, cols),
                       cols.to(index_dtype(x.shape[1])))


@dataclasses.dataclass(frozen=True)
class TopKCodec(_SparseCodec):
    """Keep the K = ratio*d largest-|x| entries per row (deterministic),
    in descending order of |x|."""
    draws = False

    def encode(self, rows: torch.Tensor, key: Key = None) -> Payload:
        del key
        x = rows.to(torch.float32)
        _, cols = torch.topk(x.abs(), self.k_of(x.shape[1]), dim=1)
        return self._payload(x, cols)


@dataclasses.dataclass(frozen=True)
class RandKCodec(_SparseCodec):
    """Keep K uniformly random distinct entries per row, fresh per key."""
    draws = True

    def encode(self, rows: torch.Tensor, key: Key = None) -> Payload:
        if key is None:
            raise ValueError("randk sampling needs a key: a torch.Generator "
                             "or an (m, K) tensor of column ids")
        x = rows.to(torch.float32)
        m, d = x.shape
        K = self.k_of(d)
        if isinstance(key, torch.Tensor):
            cols = _draws(key, (m, K), x.device, "randk")
        else:
            # the K smallest of d uniforms: a uniform K-subset, random order
            cols = torch.topk(_draws(key, (m, d), x.device, "randk"), K,
                              dim=1, largest=False).indices
        return self._payload(x, cols)


# ---------------------------------------------------------------------------
# QSGD-style stochastic quantization
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QSGDCodec:
    """Per-row linf scale + `bits`-bit stochastic rounding.  bits=8 ships
    int8 words; bits=4 nibble-packs two values per uint8.  Without a key
    the rounding is deterministic (nearest)."""
    bits: int = 8
    seed: int = 0
    exact = False
    draws = True

    def __post_init__(self) -> None:
        if self.bits not in (4, 8):
            raise ValueError(f"qsgd bits must be 4 or 8, got {self.bits}")

    @property
    def levels(self) -> int:
        return 2 ** (self.bits - 1) - 1          # 7 or 127

    def encode(self, rows: torch.Tensor, key: Key = None) -> Payload:
        x = rows.to(torch.float32)
        m, d = x.shape
        scale = x.abs().amax(dim=1, keepdim=True)                # (m, 1)
        safe = torch.where(scale > 0, scale, 1.0)
        # the reference's order of operations, so the CPU result is exact
        y = x / safe * self.levels
        u = 0.5 if key is None else _draws(key, (m, d), x.device, "qsgd")
        q = torch.clamp(torch.floor(y + u), -self.levels, self.levels)
        q = q.to(torch.int32)
        if self.bits == 8:
            return Payload(q.to(torch.int8), None, scale)
        # 4-bit: offset to [0, 14] and pack two nibbles per byte
        q4 = (q + self.levels).to(torch.uint8)
        if d % 2:
            q4 = torch.nn.functional.pad(q4, (0, 1), value=self.levels)
        packed = q4[:, 0::2] | (q4[:, 1::2] << 4)
        return Payload(packed, None, scale)

    def decode(self, payload: Payload, d: int) -> torch.Tensor:
        scale = payload.scale
        if self.bits == 8:
            q = payload.values.to(torch.float32)
        else:
            packed = payload.values
            lo = (packed & 0xF).to(torch.int32)
            hi = (packed >> 4).to(torch.int32)
            m = packed.shape[0]
            q = torch.stack([lo, hi], dim=2).reshape(m, -1)[:, :d]
            q = (q - self.levels).to(torch.float32)
        safe = torch.where(scale > 0, scale, 1.0)
        return torch.where(scale > 0, q * safe / self.levels, 0.0)

    def residual(self, rows: torch.Tensor,
                 payload: Payload) -> torch.Tensor:
        return rows.to(torch.float32) - self.decode(payload, rows.shape[1])

    def row_bytes(self, d: int) -> int:
        payload = d if self.bits == 8 else -(-d // 2)
        return payload + 4 + MU_BYTES            # + f32 scale + mu


# ---------------------------------------------------------------------------
# config-string constructor (SimConfig.codec)
# ---------------------------------------------------------------------------
KINDS = ("identity", "topk", "randk", "qsgd")

_REGISTRY: Dict[str, Callable[[float, int, int], object]] = {
    "identity": lambda ratio, bits, seed: IdentityCodec(seed=seed),
    "topk": lambda ratio, bits, seed: TopKCodec(ratio=ratio, seed=seed),
    "randk": lambda ratio, bits, seed: RandKCodec(ratio=ratio, seed=seed),
    "qsgd": lambda ratio, bits, seed: QSGDCodec(bits=bits, seed=seed),
}


def get_codec(kind: Optional[str], *, ratio: float = 1.0 / 16.0,
              bits: int = 4, seed: int = 0):
    """kind string -> codec instance; None passes through (the
    uncompressed path); unknown kinds raise with the known names."""
    if kind is None:
        return None
    try:
        factory = _REGISTRY[kind]
    except KeyError:
        raise ValueError(f"codec kind {kind!r}; known: {KINDS}") from None
    return factory(ratio, bits, seed)


def make_codec(kind: str, *, ratio: float = 1.0 / 16.0, bits: int = 4,
               seed: int = 0):
    """`get_codec` for a kind that must be known (None is not a codec)."""
    if kind is None:
        raise ValueError(f"codec kind None; known: {KINDS}")
    return get_codec(kind, ratio=ratio, bits=bits, seed=seed)
