"""Codec registry: one dispatch point for byte encode/decode.

Port of `repro.core.codecs`. The selector and the policy allowlists
address codecs by name through `get(name)`. A codec has

* ``encode(view32, selection) -> bytes`` on a folded float32 numpy view;
* ``decode(data) -> np.ndarray``, a writeable float32 array;
* capability flags: ``blockwise``, ``pointwise_bound``, ``lossless`` and
  ``device_encode`` — the codec can finish Stage III on the device through
  ``encode_device(view, selection)``, where `view` is a float32 tensor on
  the device the call runs on. It returns container bytes decodable by the
  same ``decode``, or None when the field must take the host coder.

The built-in ``sz``, ``zfp`` and ``raw`` register at import.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol, runtime_checkable

import numpy as np

from . import sz as _sz
from . import zfp as _zfp


@runtime_checkable
class Codec(Protocol):
    """The codec contract every registered compressor satisfies."""

    name: str
    blockwise: bool
    pointwise_bound: bool
    lossless: bool

    def encode(self, view32: np.ndarray, selection) -> bytes:  # pragma: no cover
        ...

    def decode(self, data: bytes) -> np.ndarray:  # pragma: no cover
        ...


@dataclass(frozen=True)
class _FnCodec:
    """A codec assembled from plain functions (how the built-ins register)."""

    name: str
    blockwise: bool
    pointwise_bound: bool
    lossless: bool
    _encode: Callable[[np.ndarray, object], bytes]
    _decode: Callable[[bytes], np.ndarray]
    #: device-resident Stage III: container bytes or None (host coder)
    _encode_device: Callable[[object, object], bytes | None] | None = None

    @property
    def device_encode(self) -> bool:
        return self._encode_device is not None

    def encode(self, view32: np.ndarray, selection) -> bytes:
        return self._encode(view32, selection)

    def encode_device(self, view, selection) -> bytes | None:
        if self._encode_device is None:
            return None
        return self._encode_device(view, selection)

    def decode(self, data: bytes) -> np.ndarray:
        return self._decode(data)


_REGISTRY: dict[str, Codec] = {}


def register(codec: Codec) -> Codec:
    """Register `codec` under `codec.name`; returns it for chaining."""
    name = codec.name
    if name in _REGISTRY:
        raise ValueError(f"codec {name!r} is already registered")
    _REGISTRY[name] = codec
    return codec


def get(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown codec {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def is_registered(name: str) -> bool:
    return name in _REGISTRY


def lossy_names() -> tuple[str, ...]:
    return tuple(n for n, c in _REGISTRY.items() if not c.lossless)


def supports_device_encode(name: str) -> bool:
    """Whether `name` can finish Stage III on the device."""
    return bool(getattr(get(name), "device_encode", False))


def writeable_frombuffer(data: bytes, dtype) -> np.ndarray:
    """`np.frombuffer` that returns a writeable array (one copy)."""
    return np.frombuffer(bytearray(data), dtype=np.dtype(dtype))


def _raw_decode(data: bytes) -> np.ndarray:
    return writeable_frombuffer(data, np.float32)


def _sz_encode_device(view, sel):
    # imported at call time: host-only decode paths never load the kernels
    from . import device_encode as _de

    return _de.sz_encode_device(view, sel.eb_sz)


def _zfp_encode_device(view, sel):
    from . import device_encode as _de

    return _de.zfp_encode_device(view, sel.eb_abs)


register(
    _FnCodec(
        "sz", blockwise=False, pointwise_bound=True, lossless=False,
        _encode=lambda view, sel: _sz.sz_compress(view, sel.eb_sz),
        _decode=_sz.sz_decompress,
        _encode_device=_sz_encode_device,
    )
)
register(
    _FnCodec(
        "zfp", blockwise=True, pointwise_bound=True, lossless=False,
        _encode=lambda view, sel: _zfp.zfp_compress(view, sel.eb_abs),
        _decode=_zfp.zfp_decompress,
        _encode_device=_zfp_encode_device,
    )
)
register(
    _FnCodec(
        "raw", blockwise=False, pointwise_bound=True, lossless=True,
        _encode=lambda view, sel: view.tobytes(),
        _decode=_raw_decode,
    )
)

#: the full built-in candidate set, in decision order
DEFAULT_CODECS: tuple[str, ...] = ("sz", "zfp", "raw")
