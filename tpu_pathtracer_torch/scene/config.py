"""Scene description: JSON config -> typed materials + asset paths.

One typed config replacing the reference's three config tiers (JSON scene
desc src/SceneDesc.cpp:16-76, compile-time macros src/renderkernel.cu:50-54,
and the copy-paste recipes in src/scenes.txt) — no recompiles.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

# Material type enum; values match reference Refl_t (src/SceneDesc.h:7-16)
MAT_EMIT = 0
MAT_DIFF = 1
MAT_GLASS = 2
MAT_REFL = 3
MAT_DIFF_REFL = 4
MAT_FRESNEL = 5
MAT_NULL = 6
MAT_SUBSURFACE = 7

REFL_NAMES = {
    "MAT_EMIT": MAT_EMIT,
    "MAT_DIFF": MAT_DIFF,
    "MAT_GLASS": MAT_GLASS,
    "MAT_REFL": MAT_REFL,
    "MAT_DIFF_REFL": MAT_DIFF_REFL,
    "MAT_FRESNEL": MAT_FRESNEL,
    "MAT_NULL": MAT_NULL,
    "MAT_SUBSURFACE": MAT_SUBSURFACE,
}

# Medium presets from reference src/scenes.txt:51-55 (sigma_s, sigma_a, g)
MEDIUM_PRESETS = {
    "cloud": ((20.0, 20.0, 20.0), (5.0, 5.0, 5.0), 0.0),
    "tea": ((0.040224 * 5, 0.045264 * 5, 0.051081 * 5), (2.4288, 4.5757, 7.2127), 0.5),
    "milk": ((4.5513 * 20, 5.8294 * 20, 7.136 * 20), (0.0015333, 0.0046, 0.019933), -0.5),
    "jade": ((45.0, 40.0, 50.0), (10.0, 5.0, 15.0), 0.2),
    "skin": ((0.74 * 1000, 0.88 * 1000, 1.01 * 1000), (0.032 * 500, 0.17 * 500, 0.48 * 500), 0.5),
}

# F0 presets from reference src/scenes.txt:45-48
F0_PRESETS = {
    "plastic": (0.04, 0.04, 0.04),
    "gold": (1.00, 0.71, 0.29),
    "silver": (0.95, 0.93, 0.88),
    "iron": (0.56, 0.57, 0.58),
}


@dataclasses.dataclass
class MatDesc:
    """Per-material record; defaults match reference MatDesc
    (src/SceneDesc.h:18-32)."""
    refltype: int = MAT_DIFF
    objcol: tuple = (1.0, 1.0, 1.0)
    emit: tuple = (0.0, 0.0, 0.0)
    alphax: float = 0.0
    alphay: float = 0.0
    kd: float = 1.0
    ks: float = 1.0
    etaT: float = 1.33
    useNormal: bool = True
    useTexture: bool = False
    F0: tuple = F0_PRESETS["iron"]
    tangent: tuple = (0.0, 1.0, -1.0)
    mfp: tuple = (1.0, 1.0, 1.0)
    # --- extensions beyond the reference record ---
    # name of a medium preset (or None). The reference shipped
    # HomogeneousMedium (src/reflection.cuh:152) but never wired it into the
    # current kernel; we expose it properly per material: a GLASS-like
    # interface whose interior scatters.
    medium: Optional[str] = None


@dataclasses.dataclass
class SceneDesc:
    scenefile: str = ""
    HDRmapname: str = ""
    textureFile: str = ""
    camFile: str = ""
    materials: List[MatDesc] = dataclasses.field(default_factory=list)
    mat_id_map: Dict[str, int] = dataclasses.field(default_factory=dict)
    # render settings (reference: compile-time macros)
    width: int = 1920
    height: int = 1080
    num_sample: int = 1           # NUM_SAMPLE, src/renderkernel.cu:50
    bounce_min: int = 2           # LIGHT_BOUNCE_NUM_MIN, src/renderkernel.cu:51
    bounce_max: int = 16          # LIGHT_BOUNCE_NUM_MAX, src/renderkernel.cu:52
    use_envmap: bool = True       # USE_ENVMAP, src/renderkernel.cu:53
    use_distant_light: bool = False  # USE_DISTANT_LIGHT, src/renderkernel.cu:54
    distant_light_L: tuple = (1.2, 1.2, 1.2)   # src/renderkernel.cu:521
    distant_light_dir: tuple = (0.0, 1.3, -3.6)  # src/renderkernel.cu:522 (normalized at use)
    env_const_color: tuple = (0.0, 0.0, 0.0)  # used when use_envmap=False


def load_scene_desc(path: str) -> SceneDesc:
    """Parse a sceneDesc.json. Accepts the reference schema
    (data/sceneDesc.json keys at src/SceneDesc.cpp:54-66) plus our render
    settings extensions."""
    with open(path) as f:
        js = json.load(f)
    desc = SceneDesc()
    desc.scenefile = js.get("scenefile", "")
    desc.HDRmapname = js.get("HDRmapname", "")
    desc.textureFile = js.get("textureFile", "")
    desc.camFile = js.get("camFile", "")
    for key in ("width", "height", "num_sample", "bounce_min", "bounce_max",
                "use_envmap", "use_distant_light"):
        if key in js:
            setattr(desc, key, js[key])
    mat_js = js.get("matDesc", {})
    for i, (name, rec) in enumerate(mat_js.items()):
        m = MatDesc()
        for k, v in rec.items():
            if k == "refltype":
                m.refltype = REFL_NAMES[v]
            elif k in ("objcol", "emit", "F0", "tangent", "mfp"):
                setattr(m, k, tuple(float(x) for x in v))
            elif k in ("alphax", "alphay", "kd", "ks", "etaT"):
                setattr(m, k, float(v))
            elif k in ("useNormal", "useTexture"):
                setattr(m, k, bool(v))
            elif k == "medium":
                m.medium = str(v)
        desc.mat_id_map[name] = i
        desc.materials.append(m)
    return desc


def materials_to_arrays(materials: List[MatDesc]):
    """Pack MatDesc records into SoA numpy arrays for device gather.

    Returns a dict of arrays, each leading dim = num materials. The wavefront
    shader gathers per-lane material params by material id (analog of the
    gpuMatDesc fetch at src/renderkernel.cu:570-582).
    """
    n = len(materials)
    if n == 0:
        materials = [MatDesc()]
        n = 1
    arr = {
        "refltype": np.array([m.refltype for m in materials], np.int32),
        "objcol": np.array([m.objcol for m in materials], np.float32),
        "emit": np.array([m.emit for m in materials], np.float32),
        "alphax": np.array([m.alphax for m in materials], np.float32),
        "alphay": np.array([m.alphay for m in materials], np.float32),
        "kd": np.array([m.kd for m in materials], np.float32),
        "ks": np.array([m.ks for m in materials], np.float32),
        "etaT": np.array([m.etaT for m in materials], np.float32),
        "useNormal": np.array([m.useNormal for m in materials], np.int32),
        "useTexture": np.array([m.useTexture for m in materials], np.int32),
        "F0": np.array([m.F0 for m in materials], np.float32),
        "tangent": np.array([m.tangent for m in materials], np.float32),
        "mfp": np.array([m.mfp for m in materials], np.float32),
    }
    # media columns: sigma_s, sigma_a, g; medium_id<0 means none
    sig_s = np.zeros((n, 3), np.float32)
    sig_a = np.zeros((n, 3), np.float32)
    g = np.zeros((n,), np.float32)
    has_med = np.zeros((n,), np.int32)
    for i, m in enumerate(materials):
        if m.medium is not None:
            ss, sa, gg = MEDIUM_PRESETS[m.medium] if isinstance(m.medium, str) else m.medium
            sig_s[i] = ss
            sig_a[i] = sa
            g[i] = gg
            has_med[i] = 1
    arr["med_sigma_s"] = sig_s
    arr["med_sigma_a"] = sig_a
    arr["med_g"] = g
    arr["has_medium"] = has_med
    return arr
