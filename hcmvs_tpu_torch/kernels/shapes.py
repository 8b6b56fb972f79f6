"""Each kernel's launches counted by the shape of its output.

``launch_shapes()`` wraps the launchers of ``hcmvs_tpu_torch.kernels``
(the ops call them through the module) inside a ``with`` block; each
wrapper adds what its launcher added to ``kernels.launches`` (which is
unchanged) under the key of its output's shape.  A run on the card reads
it to say at which shapes a path launched each kernel.
"""

from __future__ import annotations

import collections
import contextlib


def _d_mode(a) -> tuple:
    """Kernel D's mode as a launch-key suffix: none for the bounded mode
    (the paths' own), "packed" or "f32" otherwise."""
    import torch
    if a[1].dtype == torch.float32:
        return ("f32",)
    return () if len(a) > 2 and a[2] is not None else ("packed",)


# each kernel's output shape, read from its launcher's arguments: A (V,
# P_pad, 128), B (P, S) and D (P, C) with the table's depth D appended
# (P, S, D) / (P, C, D) (D's mode after that unless bounded), C ([K,] V,
# 2, H, W), E ([K,] V, H, W), K a candidate stack's size
SHAPE_OF = {
    "rect_build": lambda a: (a[0].shape[0], a[6], 128),
    "volume_lookup": lambda a: tuple(a[1].shape) + (a[0].shape[1],),
    "rect_lookup": lambda a: (tuple(a[5].shape[:-2])
                              + tuple(a[0].shape[:2])
                              + tuple(a[5].shape[-2:])),
    "volume_lookup_multi": lambda a: (tuple(a[1].shape) + (a[0].shape[1],)
                                      + _d_mode(a)),
    "zncc_warped": lambda a: (tuple(a[3].shape[:max(a[3].dim() - 2, 1)])
                              + tuple(a[1].shape))}


def shape_key(shape) -> str:
    return "x".join(x if isinstance(x, str) else str(int(x))
                    for x in shape)


@contextlib.contextmanager
def launch_shapes():
    """Counts each kernel's launches by output shape inside the block.
    Yields {kernel: Counter of shape keys}."""
    from hcmvs_tpu_torch import kernels
    counts = {name: collections.Counter() for name in SHAPE_OF}
    launchers = {name: getattr(kernels, name) for name in SHAPE_OF}

    def recorder(name):
        def recorded(*args):
            before = kernels.launches[name]
            out = launchers[name](*args)
            counts[name][shape_key(SHAPE_OF[name](args))] += (
                kernels.launches[name] - before)
            return out
        return recorded

    for name in SHAPE_OF:
        setattr(kernels, name, recorder(name))
    try:
        yield counts
    finally:
        for name, launch in launchers.items():
            setattr(kernels, name, launch)
