"""Carry state over from the reference package's objects.

Both loaders take plain numpy arrays and Python scalars — what
``np.asarray`` and attribute reads give on the reference objects — and
return port objects that compute, from there on, what the reference
objects would compute. The port does not import the reference, so the
export side is the caller's (see ``tests/test_torch_controller.py``).

Sketch arrays (``DeviceSizeSketch``): ``weights`` (dense float32, with
any buffered window flushed), ``n_observed``, ``n_dispatches``,
``n_host_syncs``, ``n_scalar_syncs``, ``half_life`` (None: no decay),
``num_buckets``, ``bucket_width`` and optionally ``window``.

Host sketch arrays (``DecayedSizeHistogram``): ``sizes``, ``weights`` and
``last`` (per-bin step of the last update), ``t``, ``total``,
``n_observed``, ``n_host_syncs``, ``n_dispatches``, ``half_life`` and
``max_bins``.

Controller arrays: ``config`` (a dict of ``ControllerConfig`` fields;
``forecast`` must be unset), ``chunks``, ``reference`` (None, a dense
float32 vector on the device path, or a ``(support, weights)`` pair on
the host path), ``since_check``, ``last_refit_at``, ``n_checks``,
``n_refits`` and ``sketch`` (sketch or host sketch arrays, matching
``config["device"]``).

Fleet sketch matrix (:func:`load_fleet_sketch`): the reference
``FleetState.sketch`` as a float32 ``[capacity, num_buckets]`` array, into
a port ``FleetState`` whose rows were allocated the same way.

Harness pools (:func:`load_harness_pools`): the reference
``OfflineHarness``'s ``k`` and ``v`` pools as float32
``(pool_rows, hkv, d)`` arrays, into a port harness built on the same
pool and shapes.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.controller import ControllerConfig, SlabController
from repro_torch.core.fleet import FleetState
from repro_torch.core.observe import DecayedSizeHistogram, DeviceSizeSketch


def load_sketch_state(arrays: Mapping, *,
                      torch_device="cuda") -> DeviceSizeSketch:
    """A :class:`DeviceSizeSketch` holding the exported sketch state."""
    sketch = DeviceSizeSketch(half_life=arrays["half_life"],
                              num_buckets=int(arrays["num_buckets"]),
                              bucket_width=int(arrays["bucket_width"]),
                              window=bool(arrays.get("window", False)),
                              torch_device=torch_device)
    weights = np.asarray(arrays["weights"], dtype=np.float32)
    if weights.shape != (sketch.num_buckets,):
        raise ValueError(f"weights shape {weights.shape} does not match "
                         f"num_buckets={sketch.num_buckets}")
    sketch._weights = torch.from_numpy(weights.copy()).to(
        sketch.torch_device)
    for name in ("n_observed", "n_dispatches", "n_host_syncs",
                 "n_scalar_syncs"):
        setattr(sketch, name, int(arrays[name]))
    return sketch


def _load_host_sketch(arrays: Mapping) -> DecayedSizeHistogram:
    sketch = DecayedSizeHistogram(half_life=arrays["half_life"],
                                  max_bins=int(arrays["max_bins"]))
    sizes = np.asarray(arrays["sizes"], dtype=np.int64).tolist()
    weights = np.asarray(arrays["weights"], dtype=np.float64).tolist()
    last = np.asarray(arrays["last"], dtype=np.int64).tolist()
    if not len(sizes) == len(weights) == len(last):
        raise ValueError("host sketch sizes/weights/last differ in length")
    sketch._w = dict(zip(sizes, weights))
    sketch._last = dict(zip(sizes, last))
    sketch._t = int(arrays["t"])
    sketch._total = float(arrays["total"])
    for name in ("n_observed", "n_host_syncs", "n_dispatches"):
        setattr(sketch, name, int(arrays[name]))
    return sketch


def load_controller_state(arrays: Mapping, *,
                          torch_device="cuda") -> SlabController:
    """A :class:`SlabController` holding the exported controller state."""
    fields = dict(arrays["config"])
    if fields.get("forecast") is not None:
        raise ValueError("forecaster state is not carried over")
    fields.pop("forecast", None)
    config = ControllerConfig(**fields, torch_device=torch_device)
    if config.device:
        sketch = load_sketch_state(arrays["sketch"],
                                   torch_device=torch_device)
    else:
        sketch = _load_host_sketch(arrays["sketch"])
    ref = arrays["reference"]
    if ref is not None:
        if config.device:
            ref = torch.from_numpy(
                np.asarray(ref, dtype=np.float32).copy()).to(
                    sketch.torch_device)
        else:
            ref = (np.asarray(ref[0], dtype=np.int64),
                   np.asarray(ref[1], dtype=np.float64))
    ctl = SlabController(arrays["chunks"], config=config, reference=ref,
                         sketch=sketch)
    ctl._since_check = int(arrays["since_check"])
    ctl._last_refit_at = int(arrays["last_refit_at"])
    ctl.n_checks = int(arrays["n_checks"])
    ctl.n_refits = int(arrays["n_refits"])
    return ctl


def load_fleet_sketch(fleet: FleetState, sketch, *,
                      torch_device="cuda") -> FleetState:
    """Copy the reference's stacked sketch matrix into ``fleet``'s
    (allocated on ``torch_device`` when the fleet has none yet). Views
    already handed out resolve their rows anew, so they see the copy.
    Returns ``fleet``."""
    sketch = np.asarray(sketch, dtype=np.float32)
    if sketch.ndim != 2 or sketch.shape[0] != fleet.capacity:
        raise ValueError(f"sketch shape {sketch.shape} does not match the "
                         f"fleet's capacity {fleet.capacity}")
    fleet.ensure_sketch(sketch.shape[1], torch_device)
    fleet.sketch.copy_(torch.from_numpy(sketch.copy()))
    return fleet


def load_harness_pools(harness, k, v):
    """Copy the reference harness's ``k`` and ``v`` pools into the port
    ``harness`` (same pool rows, heads and head dim). Returns
    ``harness``."""
    for name, dst, src in (("k", harness._k, k), ("v", harness._v, v)):
        arr = np.asarray(src, dtype=np.float32)
        if arr.shape != tuple(dst.shape):
            raise ValueError(f"{name} pool shape {arr.shape} does not "
                             f"match the harness's {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr.copy()))
    return harness

