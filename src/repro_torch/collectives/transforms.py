"""Payload transforms (port of ``repro.collectives.transforms``).

A transform decides what each reducing stage puts on the wire and how the
receiver folds it back in.  Only ``identity`` is ported; the reference's
blockwise ``int8`` wire format (and its ``mrd_combine`` kernel) waits for
the gradient-sync slice.
"""

from __future__ import annotations

from typing import Any, Callable


class IdentityTransform:
    """Raw payloads; combine = the plan's reduction op."""

    name = "identity"

    def validate_op(self, op: str | Callable):
        pass

    def encode(self, x, be):
        return (x,)

    def canonicalize(self, x, be):
        """The value a partner reconstructs from this rank's payload (the
        buffer itself for a lossless format)."""
        return x

    def combine(self, keep, payload, op: Callable, be):
        (recv,) = payload
        return op(keep, recv)


TRANSFORMS: dict[str, Callable[..., Any]] = {}


def register_transform(name: str):
    def deco(factory):
        TRANSFORMS[name] = factory
        return factory

    return deco


register_transform("identity")(lambda **kw: IdentityTransform())


def resolve_transform(transform, **kw):
    """Accept a name, a transform instance, or None (identity)."""
    if transform is None:
        return IdentityTransform()
    if isinstance(transform, str):
        try:
            return TRANSFORMS[transform](**kw)
        except KeyError:
            raise ValueError(
                f"unknown transform {transform!r}; registered: {sorted(TRANSFORMS)}"
            ) from None
    return transform
