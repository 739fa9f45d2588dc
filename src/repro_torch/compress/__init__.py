"""Compressed directed gossip: wire codecs and error feedback (port of
`repro/compress`)."""
from .codecs import (KINDS, MU_BYTES, Codec, IdentityCodec, Payload, QSGDCodec,
                     RandKCodec, TopKCodec, get_codec, index_dtype,
                     make_codec)
from .feedback import decode, encode_with_feedback, init_ef, init_ref, publish

__all__ = [
    "KINDS", "MU_BYTES", "Codec", "IdentityCodec", "Payload", "QSGDCodec",
    "RandKCodec", "TopKCodec", "get_codec", "index_dtype", "make_codec",
    "decode", "encode_with_feedback", "init_ef", "init_ref", "publish",
]
