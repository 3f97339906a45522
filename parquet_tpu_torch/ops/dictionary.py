"""RLE_DICTIONARY index codec (host path).

Data pages of dictionary-encoded columns carry: 1 byte bit-width, then a hybrid
RLE/bit-packed stream of indices into the dictionary page (reference:
type_dict.go:22-60, :135-159). Index bounds are validated against the
dictionary size before any gather (reference: type_dict.go:52-54).
"""

from __future__ import annotations

import numpy as np

from .bitpack import bit_width
from .rle_hybrid import decode_hybrid, encode_hybrid

__all__ = ["decode_dict_indices", "encode_dict_indices", "DictError"]


class DictError(ValueError):
    pass


def decode_dict_indices(data, num_values: int, dict_size: int) -> np.ndarray:
    buf = memoryview(data) if not isinstance(data, memoryview) else data
    if num_values == 0:
        return np.empty(0, dtype=np.uint32)
    if len(buf) < 1:
        raise DictError("dict: missing bit-width byte")
    width = buf[0]
    if width > 32:
        raise DictError(f"dict: invalid index bit width {width}")
    indices = decode_hybrid(buf[1:], num_values, width, dtype=np.uint32)
    if indices.size and int(indices.max()) >= dict_size:
        raise DictError(
            f"dict: index {int(indices.max())} out of range (dictionary has {dict_size})"
        )
    return indices


def encode_dict_indices(indices, dict_size: int) -> bytes:
    width = bit_width(max(dict_size - 1, 0))
    return bytes([width]) + encode_hybrid(np.asarray(indices), width)
