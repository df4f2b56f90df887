"""The bench's camera rigs, f32 projection matrices as the JAX package's
bench scripts build them: ``look_at`` and ``ring_projs`` (``bench.py``),
``ring_rig`` and ``translation_rig`` (``scripts/bench_configs.py``), equal
byte for byte. ``look_at`` is ``data/synthetic.py``'s camera, the same
function as the scripts'."""

from __future__ import annotations

import numpy as np

from ..data.synthetic import _look_at as look_at


def ring_projs(n_cams: int, views, radius: float, height: float, target_z: float, K: np.ndarray) -> np.ndarray:
    """[len(views), 4, 4]: K @ E of ``views`` of an ``n_cams`` inward ring at
    ``radius`` and z = ``height``, looking at (0, 0, ``target_z``) (the
    DTU/BDS8 overhead acquisition geometry)."""
    projs = []
    for i in views:
        a = 2 * np.pi * i / n_cams
        eye = (radius * np.cos(a), radius * np.sin(a), height)
        E = look_at(eye, (0.0, 0.0, target_z))
        P = E.copy()
        P[:3, :4] = K @ E[:3, :4]
        projs.append(P)
    return np.stack(projs)


def ring_rig(n_cams: int, radius: float, height: float, target_z: float, K: np.ndarray) -> np.ndarray:
    """Every camera of the inward ring (the BDS8 and bin overhead geometry)."""
    return ring_projs(n_cams, range(n_cams), radius, height, target_z, K)


def translation_rig(n_cams: int, baseline: float, K: np.ndarray) -> np.ndarray:
    """[n_cams, 4, 4]: cameras ``baseline`` apart along world x."""
    projs = []
    for v in range(n_cams):
        E = np.eye(4, dtype=np.float32)
        E[0, 3] = -baseline * v
        P = E.copy()
        P[:3, :4] = K @ E[:3, :4]
        projs.append(P)
    return np.stack(projs)
