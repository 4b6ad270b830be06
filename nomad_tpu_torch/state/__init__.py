"""MVCC state store (ref nomad/state/)."""

from .store import Generation, StateReader, StateSnapshot, StateStore
