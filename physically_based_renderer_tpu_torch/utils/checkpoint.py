"""Checkpoint and resume of a scene's optimisable parts — the counterpart of
``physically_based_renderer_tpu/utils/checkpoint.py``, whose files it reads
and writes.

Two layouts of one ``.npz``:

  * the JAX package's: arrays ``leaf_0``, ``leaf_1``, … in
    ``jax.tree.flatten`` order (dict keys sorted; a dataclass's data fields
    in declaration order; a None is no leaf) and a manifest
    ``{"treedef", "kinds"}``. :func:`save_scene_params` writes it, so either
    package restores the other's file;
  * the port's named layout: a nested dict of tensors flattened to
    ``"a/b"`` keys, the None leaves listed in the manifest's ``"none"``.
    :func:`save_tensors` writes it.

:func:`load_tensors` and :func:`load_scene_params` read both. Arrays restore
onto the device and dtype of the tensors they replace.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

_MANIFEST = "__manifest__"
_LIGHT_FIELDS = ("strength", "direction", "position", "spot_power")  # Lights' data fields, declared order


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _read(path: str) -> tuple[dict, dict]:
    """(arrays by key, manifest) of a checkpoint file."""
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files if k != _MANIFEST}
        manifest = json.loads(bytes(data[_MANIFEST]).decode()) if _MANIFEST in data.files else {}
    return stored, manifest


def _jax_leaves(stored: dict, manifest: dict) -> list[np.ndarray]:
    """The leaves of a JAX-layout file in flatten order."""
    return [stored[f"leaf_{i}"] for i, kind in enumerate(manifest["kinds"]) if kind == "array"]


def _restore(arr: np.ndarray, like: torch.Tensor | None, device=None) -> torch.Tensor:
    t = torch.as_tensor(arr)
    return t.to(device) if like is None else t.to(device=like.device, dtype=like.dtype)


def save_tensors(path: str, tree: dict) -> None:
    """Save a nested dict of tensors (and None leaves) to ``path`` (.npz), in
    the named layout."""
    flat = _flatten(tree)
    arrays = {k: v.detach().cpu().numpy() for k, v in flat.items() if v is not None}
    manifest = json.dumps({"none": sorted(k for k, v in flat.items() if v is None)})
    np.savez(path, **{_MANIFEST: np.frombuffer(manifest.encode(), np.uint8)}, **arrays)


def load_tensors(path: str, like: dict) -> dict:
    """Restore a nested dict shaped as ``like`` from a file in either layout.
    Named layout: each leaf the file names is read onto that leaf's device
    and dtype; a leaf the file lists as None is None; a leaf the file does
    not name keeps ``like``'s value. JAX layout (a flattened dict of
    arrays): the file's leaves fill ``like``'s leaves in sorted-key order,
    where ``like``'s None leaves are no leaves; the counts must agree."""
    stored, manifest = _read(path)
    if "kinds" in manifest:
        flat = _flatten_sorted(like)
        keys = [k for k, v in flat.items() if v is not None]
        leaves = _jax_leaves(stored, manifest)
        if len(leaves) != len(keys):
            raise ValueError(f"{path}: {len(leaves)} leaves in the file, {len(keys)} in the tree to restore")
        by_key = dict(zip(keys, leaves))
        return _unflatten(like, lambda key, v: v if key not in by_key else _restore(by_key[key], v))
    none = set(manifest.get("none", ()))

    def leaf(key, v):
        if key in none:
            return None
        return _restore(stored[key], v) if key in stored else v

    return _unflatten(like, leaf)


def _flatten_sorted(tree: dict, prefix: str = "") -> dict:
    """``_flatten`` with the keys of every dict sorted, as ``jax.tree.flatten``."""
    out = {}
    for k in sorted(tree):
        v, key = tree[k], f"{prefix}{k}"
        out.update(_flatten_sorted(v, key + "/") if isinstance(v, dict) else {key: v})
    return out


def _unflatten(tree: dict, leaf, prefix: str = "") -> dict:
    return {k: _unflatten(v, leaf, f"{prefix}{k}/") if isinstance(v, dict) else leaf(f"{prefix}{k}", v)
            for k, v in tree.items()}


def _scene_leaves(scene, env_map) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of the optimisable parts in the JAX package's flatten
    order of {ambient, env_map, lights, materials}; ``env_map`` None is no
    leaf."""
    mats = scene.materials
    leaves = [("ambient", scene.ambient)]
    if env_map is not None:
        leaves.append(("env_map", env_map))
    leaves += [(f"lights/{k}", getattr(scene.lights, k)) for k in _LIGHT_FIELDS]
    # tensor_fields() keeps the declaration order, which the JAX MaterialBank shares
    leaves += [(f"materials/{k}", getattr(mats, k)) for k in mats.tensor_fields()]
    return leaves


def save_scene_params(path: str, scene) -> None:
    """Save the optimisable parts of a scene — the ambient colour, the
    environment map, the lights and the material bank — in the JAX
    package's layout, so its ``load_scene_params`` restores them."""
    leaves = _scene_leaves(scene, scene.env_map)
    manifest = json.dumps({
        "treedef": "{'ambient': *, 'env_map': " + ("*" if scene.env_map is not None else "None")
                   + ", 'lights': Lights(" + ", ".join(_LIGHT_FIELDS) + "), 'materials': MaterialBank("
                   + ", ".join(scene.materials.tensor_fields()) + ")}",
        "kinds": ["array"] * len(leaves),
    })
    arrays = {f"leaf_{i}": t.detach().cpu().numpy() for i, (_, t) in enumerate(leaves)}
    np.savez(path, **{_MANIFEST: np.frombuffer(manifest.encode(), np.uint8)}, **arrays)


def load_scene_params(path: str, scene):
    """``scene`` with the parts a ``save_scene_params`` of either package
    wrote restored (or a file of the port's earlier named layout). A JAX
    file holds an environment map or not, whatever ``scene`` holds: the
    leaf count tells which, and a restored map lands on the ambient's
    device."""
    stored, manifest = _read(path)
    if "kinds" not in manifest:  # the named layout
        p = load_tensors(path, {
            "materials": {k: getattr(scene.materials, k) for k in scene.materials.tensor_fields()},
            "lights": {k: getattr(scene.lights, k) for k in _LIGHT_FIELDS},
            "ambient": scene.ambient,
            "env_map": scene.env_map,
        })
        restored = {"ambient": p["ambient"], "env_map": p["env_map"]}
        restored.update({f"lights/{k}": v for k, v in p["lights"].items()})
        restored.update({f"materials/{k}": v for k, v in p["materials"].items()})
    else:
        leaves = _jax_leaves(stored, manifest)
        with_env = _scene_leaves(scene, scene.ambient)  # the order with a map (its "like" is a stand-in)
        if len(leaves) == len(with_env):
            order = with_env
        elif len(leaves) == len(with_env) - 1:
            order = _scene_leaves(scene, None)
        else:
            raise ValueError(f"{path}: {len(leaves)} leaves, expected {len(with_env) - 1} or {len(with_env)}")
        restored = {"env_map": None}
        for (name, like), arr in zip(order, leaves):
            if name == "env_map":
                like = scene.env_map
            restored[name] = _restore(arr, like, device=scene.ambient.device)
    mats = {k: restored[f"materials/{k}"] for k in scene.materials.tensor_fields()}
    return dataclasses.replace(
        scene,
        materials=dataclasses.replace(scene.materials, **mats),
        lights=dataclasses.replace(scene.lights, **{k: restored[f"lights/{k}"] for k in _LIGHT_FIELDS}),
        ambient=restored["ambient"],
        env_map=restored["env_map"],
    )
