"""Client-side local training, vmapped across the selected cohort.

Port of the JAX package's ``fed/client.py``.  Parameters are plain
dictionaries of tensors (a state dict of :class:`repro_torch.models.cnn.CNN`);
the model module only supplies the architecture through
``torch.func.functional_call``.  All clients of a cohort train together:
their parameters are stacked along a leading cohort axis and one
``torch.func.vmap`` of ``torch.func.grad_and_value`` takes a local SGD
step for every client at once.

The pooling noise is an input: ``noise(step)`` returns the Gumbel draws of
one local step for every client, (K, B, C, H/2, W/2, 4), so the caller
decides where they come from (a CPU generator in the runner, the JAX
package's draws in a parity test).
"""

from __future__ import annotations

import torch

from repro_torch.models.cnn import cnn_loss


def sgd_tree(params, grads, lr):
    return {k: p - lr * grads[k] for k, p in params.items()}


def _step_loss(model):
    def loss(params, x, y, noise):
        return cnn_loss(model, {"x": x, "y": y}, noise, params=params)[0]
    return loss


def local_train(model, params, xs, ys, noise, lr):
    """Local SGD of one client.  xs: (steps, B, H, W, C), ys: (steps, B);
    ``noise(step)`` -> (B, C, H/2, W/2, 4).  Returns (params, mean loss)."""
    step_fn = torch.func.grad_and_value(_step_loss(model))
    losses = []
    for s in range(xs.shape[0]):
        grads, loss = step_fn(params, xs[s], ys[s], noise(s))
        params = sgd_tree(params, grads, lr)
        losses.append(loss)
    return params, torch.stack(losses).mean()


def local_train_cohort(model, params, xs, ys, noise, *, lr: float):
    """vmapped local training of K clients from the same global model.

    params: global parameters (broadcast to every client).
    xs: (K, steps, B, H, W, C); ys: (K, steps, B) int64;
    ``noise(step)`` -> (K, B, C, H/2, W/2, 4).
    Returns (stacked client params with leading K axis, (K,) mean losses).
    """
    k = xs.shape[0]
    step_fn = torch.func.vmap(torch.func.grad_and_value(_step_loss(model)))
    stacked = {name: p.detach().expand(k, *p.shape)
               for name, p in params.items()}
    losses = []
    for s in range(xs.shape[1]):
        grads, loss = step_fn(stacked, xs[:, s], ys[:, s], noise(s))
        stacked = sgd_tree(stacked, grads, lr)
        losses.append(loss)
    return stacked, torch.stack(losses).mean(0)


def evaluate(model, params, x, y):
    """Full-batch eval: returns (accuracy, mean loss, logits) tensors."""
    with torch.no_grad():
        loss, logits = cnn_loss(model, {"x": x, "y": y}, params=params)
        acc = (torch.argmax(logits, dim=-1) == y).float().mean()
    return acc, loss, logits
