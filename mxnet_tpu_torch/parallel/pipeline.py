"""Pipeline parallelism (port of ``mxnet_tpu/parallel/pipeline.py``):
stage-major layer grouping and the GPipe microbatch schedule over the
'pp' mesh axis.

The L layers of a homogeneous stack are grouped into S = |pp| stages;
each rank runs its stage's L/S layers. Microbatches enter stage 0 one per
tick; activations move to the next stage with ``ring_permute``, so after
the S - 1 tick fill every rank computes every tick (the GPipe schedule,
M + S - 1 ticks for M microbatches). The JAX package writes the ticks as
a ``lax.scan`` inside a ``shard_map`` manual over pp; here each rank runs
them as a loop over its own stage, and the differentiable
``ring_permute`` carries the cotangents back through the same ticks in
backward. Every rank applies its stage at every tick, bubbles included,
and takes the activation it receives even where it reads a microbatch
instead (stage 0), so every rank's backward issues the same permutes in
the same order. A layer body that issues its own collectives (ring
attention over sp inside a stage) runs them as it would outside.
"""

import torch

from . import all_reduce, current_mesh, pvary, ring_permute

__all__ = ["stack_stage_params", "spmd_pipeline"]


def stack_stage_params(layer_params, n_stages):
    """A list of L per-layer parameter sets -> S lists of L/S layers,
    stage-major (stage s holds layers s*L/S .. (s+1)*L/S - 1)."""
    n = len(layer_params)
    if n % n_stages != 0:
        raise ValueError("n_layers (%d) must divide by n_stages (%d)"
                         % (n, n_stages))
    per = n // n_stages
    return [list(layer_params[s * per:(s + 1) * per])
            for s in range(n_stages)]


def spmd_pipeline(layer_fn, stage_params, x, mesh=None, axis_name="pp",
                  num_microbatches=None):
    """Apply a stack of layers to x through an S-stage pipeline.

    layer_fn(p_layer, x_mb) -> x_mb applies ONE layer to one microbatch.
    stage_params: this rank's stage, a list of L/S per-layer parameter
    sets (one entry of :func:`stack_stage_params`). x: [B, ...], the same
    on every rank of the axis; split into ``num_microbatches`` (default
    S) along dim 0. Returns y: [B, ...] == layer_fn applied L times to
    each sample, on every rank of the axis."""
    mesh = mesh or current_mesh()
    n_stages = mesh.axis_size(axis_name)
    stage = mesh.axis_index(axis_name)
    m = int(num_microbatches or n_stages)
    b = x.shape[0]
    if b % m != 0:
        raise ValueError("batch %d must divide by num_microbatches %d"
                         % (b, m))
    # x enters stage 0 only: its gradient is summed over the stages
    mb = pvary(x, axis_name, mesh).reshape((m, b // m) + tuple(x.shape[1:]))
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)

    def apply_stage(h):
        for p in stage_params:
            h = layer_fn(p, h)
        return h

    state = torch.zeros_like(mb[0])
    outs = []
    n_ticks = m + n_stages - 1
    for t in range(n_ticks):
        # stage 0 ingests microbatch t; the others consume the activation
        # their left neighbour sent
        y = apply_stage(torch.where(first, mb[min(t, m - 1)], state))
        if t >= n_stages - 1:
            # the last stage finished microbatch t - (S - 1) this tick
            outs.append(y)
        if t + 1 < n_ticks:
            state = ring_permute(y, axis_name, 1, mesh=mesh)
    # only the last stage holds the outputs; the sum over pp sends them to
    # every stage
    out = torch.stack(outs)
    out = all_reduce(torch.where(last, out, torch.zeros_like(out)), axis_name,
                     mesh=mesh)
    return out.reshape(x.shape)
