"""Parity weights for the port's tests: the JAX package's params pytree for
a config, built without running the JAX init.

`seeded_tree` takes the init's structure from `jax.eval_shape` and draws
every leaf from a numpy seed at fan-in scale, so activations neither
vanish nor explode through the depth. `detecting_tree` also patches the
detect head's out convs the way xrseg_tpu.testing.detection_params does,
uncalibrated: class `label` at logit 2.0 with a small spread, each
anchor's box a small square centred on itself, so every anchor detects
and every slate fills. Both cost well under a second; the jitted JAX
init behind detection_params costs about 25 s.
"""
import jax
import numpy as np

from xrseg_tpu.models import yolo11 as jy


def seeded_tree(jcfg, seed=0):
    """The JAX init's structure for `jcfg`, every leaf from a numpy seed."""
    tree = jax.eval_shape(lambda k: jy.init_params(k, jcfg),
                          jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if a.ndim == 4:     # HWIO conv / [kH,kW,I,O] transposed conv
            fan_in = a.shape[0] * a.shape[1] * a.shape[2]
            std = (1.0 / fan_in) ** 0.5 * (1.0 if name == "up_w" else 1.5)
        elif name == "lin_w":
            std = (1.0 / a.shape[0]) ** 0.5
        else:
            std = 0.1
        return (rng.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def detecting_tree(jcfg, seed=0, label=0):
    """seeded_tree with the detect head patched so every anchor detects
    class `label` (a classify tree has no detect head and is returned as
    it is)."""
    p = seeded_tree(jcfg, seed)
    if "det" not in p:
        return p
    rm = jcfg.reg_max
    for d3, d2 in zip(p["det"]["cv3"], p["det"]["cv2"]):
        d3["out"]["w"] = d3["out"]["w"] * np.float32(0.3)
        d3["out"]["b"] = np.full(jcfg.num_classes, -8.0, np.float32)
        d3["out"]["b"][label] = 2.0
        d2["out"]["b"] = np.zeros(4 * rm, np.float32)
        d2["out"]["b"][1::rm] = 8.0
        d2["out"]["w"] = d2["out"]["w"] * np.float32(1e-3)
    return p
