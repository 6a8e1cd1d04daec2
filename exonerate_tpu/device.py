"""What is attached, and which engine tier runs where.

Every engine choice that depends on the hardware asks this module; no
other module compares backend names.  It answers four questions:

- which accelerator is attached (``describe``);
- does the default heuristic run its seeded DP passes on the device
  (``sdp_tier``);
- does exhaustive DP above the native-cell threshold go to the device
  (``exhaustive_on_device``);
- how many diagonals each scan step folds, per platform
  (``wavefront_unroll``, ``sdp_fold``).

Platforms: ``gpu`` is the accelerator; ``cpu`` runs the same JAX code
under XLA's CPU backend (tests, or a machine without a card).  Any other
platform is an error, not a default.
"""
from __future__ import annotations

import os

# diagonals folded into one `lax.scan` step.  XLA runs a scan on the
# GPU as a while loop whose every iteration relaunches the step's fused
# kernels, so folding trades a larger step body for fewer iterations.
# Chosen from one H100 measurement of 1, 2, 4 and 8 (PERF.md); on the
# CPU folding only lengthens compilation.
_WAVEFRONT_UNROLL = {"cpu": 1, "gpu": 4}
_SDP_FOLD = {"cpu": 1, "gpu": 2}

SDP_TIERS = ("device", "native", "python")


def platform() -> str:
    """JAX's default platform: 'gpu' or 'cpu'."""
    import jax
    p = jax.default_backend()
    if p not in _WAVEFRONT_UNROLL:
        raise RuntimeError(f"unsupported JAX platform {p!r}: exonerate_tpu "
                           "runs on 'gpu' or 'cpu'")
    return p


def describe() -> dict:
    """{'platform', 'kind', 'count'} of the attached devices."""
    import jax
    devs = jax.devices()
    return {"platform": platform(), "kind": devs[0].device_kind,
            "count": len(devs)}


def accelerator() -> bool:
    """Is a GPU attached (and JAX using it)?"""
    return platform() == "gpu"


def sdp_tier() -> str:
    """Engine for the default heuristic's seeded DP passes.

    EXONERATE_TPU_SDP=device|native|python forces a tier (``device`` on
    the CPU runs the same XLA scan, which is how the tests reach it);
    unset, the device tier serves when an accelerator is attached and
    the host C++ scheduler otherwise."""
    env = os.environ.get("EXONERATE_TPU_SDP", "")
    if env:
        if env not in SDP_TIERS:
            raise ValueError(f"EXONERATE_TPU_SDP={env!r}: expected one of "
                             f"{', '.join(SDP_TIERS)}")
        return env
    return "device" if accelerator() else "native"


def exhaustive_on_device() -> bool:
    """Exhaustive DP above the native-cell threshold runs on the device
    (engine/wavefront.py) when an accelerator is attached."""
    return accelerator()


def wavefront_unroll() -> int:
    """Diagonals per step of the exhaustive wavefront scan."""
    return _WAVEFRONT_UNROLL[platform()]


def sdp_fold() -> int:
    """Diagonals per step of the seeded-DP band scan (sdp_device)."""
    return _SDP_FOLD[platform()]
