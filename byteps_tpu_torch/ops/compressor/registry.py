"""String-kwargs compressor registry.

Counterpart of ``byteps_tpu/ops/compressor/registry.py`` (a copy: that
module is framework-free, but importing it would import the JAX package).
It layers momentum -> error feedback -> compressor from string kwargs, the
server-side instantiation skipping momentum, as the reference registry
does (compressor_registry.cc:39-56), and accepts both the short keys
("compressor") and the reference's prefixed ones ("byteps_compressor_type").
"""

from __future__ import annotations

from typing import Callable, Dict

from .base import InterCompressor
from .decorators import ErrorFeedback, NesterovMomentum
from .dithering import DitheringCompressor
from .onebit import OnebitCompressor
from .randomk import RandomkCompressor
from .topk import TopkCompressor

_FACTORIES: Dict[str, Callable[..., InterCompressor]] = {}


def register(name: str):
    def deco(fn):
        _FACTORIES[name] = fn
        return fn
    return deco


@register("onebit")
def _make_onebit(kw):
    return OnebitCompressor(scaled=_get_bool(kw, "onebit_scaling", True))


@register("topk")
def _make_topk(kw):
    return TopkCompressor(k=int(_get(kw, "k", 0)))


@register("randomk")
def _make_randomk(kw):
    return RandomkCompressor(k=int(_get(kw, "k", 0)),
                             seed=int(_get(kw, "seed", 2020)))


@register("dithering")
def _make_dithering(kw):
    return DitheringCompressor(
        s=int(_get(kw, "k", 127)),
        seed=int(_get(kw, "seed", 2020)),
        partition=str(_get(kw, "partition", "linear")),
        normalize=str(_get(kw, "normalize", "max")))


def _get(kw: dict, name: str, default):
    """Look up `name`, `compressor_<name>`, or `byteps_compressor_<name>`."""
    for key in (name, f"compressor_{name}", f"byteps_compressor_{name}"):
        if key in kw:
            return kw[key]
    return default


def _get_bool(kw: dict, name: str, default: bool) -> bool:
    v = _get(kw, name, default)
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def parse_ef(kw: dict) -> bool:
    """Whether the kwargs ask for error feedback (the same strings the
    JAX package accepts)."""
    ef = (kw.get("ef") or kw.get("ef_type")
          or kw.get("byteps_error_feedback_type"))
    if ef and ef not in ("vanilla", "true", "1"):
        raise ValueError(f"unknown error-feedback type {ef!r}")
    return bool(ef)


def parse_momentum(kw: dict) -> float:
    """Shared momentum-kwargs parse; returns mu (0.0 = momentum off)."""
    mom = (kw.get("momentum") or kw.get("momentum_type")
           or kw.get("byteps_momentum_type"))
    if not mom:
        return 0.0
    if mom not in ("nesterov", "true", "1"):
        raise ValueError(f"unknown momentum type {mom!r}")
    return float(kw.get("momentum_mu", kw.get("byteps_momentum_mu", 0.9)))


def create(kwargs: dict, server: bool = False) -> InterCompressor:
    """Build the layered compressor from string kwargs.

    Layering order (outermost first): momentum → error-feedback → compressor,
    with momentum skipped on the server, exactly as the reference registry
    does (compressor_registry.cc:39-56).
    """
    kw = dict(kwargs)
    ctype = (kw.get("compressor") or kw.get("compressor_type")
             or kw.get("byteps_compressor_type"))
    if ctype is None:
        raise ValueError(f"no compressor type in kwargs: {sorted(kw)}")
    if ctype not in _FACTORIES:
        raise ValueError(
            f"unknown compressor {ctype!r}; known: {sorted(_FACTORIES)}")
    comp = _FACTORIES[ctype](kw)

    if parse_ef(kw):
        comp = ErrorFeedback(comp)

    mu = parse_momentum(kw)
    if mu and not server:
        comp = NesterovMomentum(comp, mu=mu)
    return comp


def known_compressors():
    return sorted(_FACTORIES)
