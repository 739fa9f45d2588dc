"""Round gauges and wire-byte arithmetic (port of part of
`repro/obs/gauges.py`): the error-feedback signal ratio that
`DFedPGP(codec_gamma="auto")` reads, and the host-side wire meter of the
synchronous simulator.  The rest of the reference's gauges are ported with
observability (ROADMAP queue 1 item 13)."""
from __future__ import annotations

import torch

from ..compress.codecs import MU_BYTES
from ..core.topology import SparseTopology


def ef_signal_ratio(flat: torch.Tensor, ef: torch.Tensor) -> torch.Tensor:
    """||u|| / (||u|| + ||ef||) in f32, in (0, 1]: 1.0 means the codec pipe
    keeps up (zero residual); a falling ratio means the wire drops value
    faster than it drains."""
    un = torch.linalg.vector_norm(flat.to(torch.float32))
    en = torch.linalg.vector_norm(ef.to(torch.float32))
    eps = 1e-12
    return (un + eps) / (un + en + eps)


def payload_row_bytes(codec, d_wire: int) -> int:
    """Bytes one client payload costs on the wire: the codec's metered row
    size, or the uncompressed f32 row + the mu scalar."""
    if codec is not None:
        return int(codec.row_bytes(d_wire))
    return 4 * d_wire + MU_BYTES


def bootstrap_bytes(codec, m: int, d_wire: int) -> int:
    """Reference-bootstrap cost of a lossy codec: first contact ships one
    full-fidelity f32 row per client (compress.init_ref).  Exact or absent
    codecs cost zero."""
    if codec is None or codec.exact:
        return 0
    return m * 4 * d_wire


def edge_count(P) -> int:
    """The number of payload-carrying directed non-self edges (positive
    weight) of a concrete round topology — a SparseTopology or a dense
    (m, m) matrix."""
    if isinstance(P, SparseTopology):
        rows = torch.arange(P.idx.shape[0], device=P.idx.device)[:, None]
        return int(((P.w > 0) & (P.idx.long() != rows)).sum())
    eye = torch.eye(P.shape[0], dtype=torch.bool, device=P.device)
    return int(((P > 0) & ~eye).sum())
