"""Host-side registries keyed by id() of a device array.

Each entry holds a strong ref to the key array (prevents id reuse). They let
specialize_config and build_scene derive static scene info WITHOUT
device->host readbacks (each one a synchronization with the device).
"""
from __future__ import annotations

_HOST_DATA: dict[int, tuple] = {}
_SPECIALIZE_CACHE: dict[int, tuple] = {}


def register_host(key_arr, data) -> None:
    _HOST_DATA[id(key_arr)] = (key_arr, data)


def get_host(key_arr):
    ent = _HOST_DATA.get(id(key_arr))
    if ent is not None and ent[0] is key_arr:
        return ent[1]
    return None


def register_specialization(key_arr, fields: dict) -> None:
    _SPECIALIZE_CACHE[id(key_arr)] = (key_arr, fields)


def get_specialization(key_arr):
    ent = _SPECIALIZE_CACHE.get(id(key_arr))
    if ent is not None and ent[0] is key_arr:
        return ent[1]
    return None
