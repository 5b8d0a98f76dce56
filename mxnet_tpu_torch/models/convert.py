"""Parameters between the JAX package and the port.

The JAX package keeps the transformer's parameters as a tree of arrays
({"embed", "pos", "ln_f", "layers": [{"ln1", "ln2", "wq", "wk", "wv",
"wo", "w1", "w2"}, ...]}); the port keeps them in a
:class:`~.transformer.TransformerLM` with the same names and shapes.
The tree crosses as numpy arrays, so this module imports nothing of JAX.
"""

import numpy as np

from .transformer import TransformerLM, load_numpy_tree

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(tree, cfg, device=None):
    """A :class:`TransformerLM` on ``device`` holding the JAX package's
    parameter tree ``tree`` (numpy arrays, e.g. ``jax.tree.map(np.asarray,
    params)``). ``device`` defaults to the current CUDA device."""
    return load_numpy_tree(TransformerLM(cfg, device), tree)


def params_to_numpy(model):
    """The inverse: ``model``'s parameters as a JAX-shaped tree of numpy
    arrays (bfloat16 parameters come back as float32, which holds them
    exactly)."""
    def arr(t):
        return t.detach().float().cpu().numpy() if t.dtype.itemsize == 2 \
            else t.detach().cpu().numpy()

    return {"embed": arr(model.embed), "pos": arr(model.pos),
            "ln_f": arr(model.ln_f),
            "layers": [{n: arr(t) for n, t in layer.named_parameters()}
                       for layer in model.layers]}
