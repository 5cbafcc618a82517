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
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.controller import ControllerConfig, SlabController
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
