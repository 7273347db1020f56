"""Shared helpers for the named-reference factories.

Every factory (``make_classify`` / ``make_clock`` / ``make_executor`` /
``make_source`` / ``make_model``) resolves a registry name and fails the
same way: a ``ValueError`` naming the kind, the offending name, and the
known choices.
"""
from __future__ import annotations

from typing import Iterable, Mapping


def unknown_name(kind: str, name: object, known: Iterable) -> ValueError:
    """The unified unknown-registry-name error (raise the return value)."""
    return ValueError(f"unknown {kind} {name!r}; "
                      f"choose from {sorted(known, key=str)}")


def lookup(kind: str, mapping: Mapping, name: object):
    """``mapping[name]`` with the unified error on a miss."""
    try:
        return mapping[name]
    except KeyError:
        raise unknown_name(kind, name, mapping) from None
