"""The port's ``loss_fn`` and its gradients against the reference's
``jax.value_and_grad(loss_fn)``, on every arch's smoke config (f32).

Parameters come from the reference's ``init_params`` (gates at 0.5) and
cross through ``convert.params_from_numpy``; the batch is drawn from a
numpy seed.  The loss is held within LOSS_TOL, and every gradient leaf
within GRAD_TOL of its largest magnitude: the two packages run the same
operations, and what differs is the order of float32 sums inside the
products, reductions and their transposes (readings on the CPU: 5e-7 to
2.2e-6 of a leaf's scale, the largest on llama-3.2-vision's gate and
hymba's ``x_proj``).  A leaf whose gradient is None or zero where the
reference's is not fails: that is what a layer reading a view made before
its parameter became trainable would give (the view has no ``grad_fn``).
Also: the remat names and the trainable and frozen modes
(``test_torch_train_step.py`` holds the remat values)."""

import pytest
import torch

from _torch_training import (flat, grads_of, make_batch, np_tree, pair,
                             rel_err, to_jax, to_torch)
import jax  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.models import forward, loss_fn  # noqa: E402
from repro_torch.models.model import REMATS  # noqa: E402

B, S = 2, 16
LOSS_TOL = 4e-6
GRAD_TOL = 2e-5
# xlstm's gates exponentiate: each mLSTM layer turns the rounding of its
# gate products into relative error through exp (ROADMAP Queue 3, the f32
# conditioning J2 reads at full width); the smoke config reads 1.7e-6,
# and its bound keeps room for that growth
GRAD_TOL_XLSTM = 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_the_reference(arch):
    cfg, jcfg, jp, model = pair(arch)
    nb = make_batch(cfg, B, S, seed=1)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, to_jax(nb), remat="full"),
        has_aux=True))(jp)
    loss, aux, grads = grads_of(model.trainable(), cfg, to_torch(nb), "full")
    for got, want in ((loss, jl), (aux["nll"], jaux["nll"]),
                      (aux["aux"], jaux["aux"])):
        assert abs(float(got.detach()) - float(want)) <= LOSS_TOL
    want = flat(np_tree(jg))
    assert set(grads) == set(want)
    tol = GRAD_TOL_XLSTM if arch == "xlstm-1.3b" else GRAD_TOL
    for name, g in grads.items():
        ref_nonzero = bool((want[name] != 0).any())
        assert g is not None or not ref_nonzero, f"{name}: no gradient"
        if g is None:
            continue
        if ref_nonzero:
            assert bool((g != 0).any()), f"{name}: zero gradient"
        assert rel_err(g, want[name]) <= tol, (name, rel_err(g, want[name]))


def test_unknown_remat_raises_as_the_reference_does():
    cfg, jcfg, jp, model = pair("qwen2-0.5b")
    nb = make_batch(cfg, B, S, seed=3)
    with pytest.raises(ValueError, match="everything"):
        jmodel.loss_fn(jp, jcfg, to_jax(nb), remat="everything")
    with pytest.raises(ValueError, match="everything"):
        loss_fn(model, cfg, to_torch(nb), remat="everything")
    assert set(REMATS) == {None, "none", "full", "dots", "dots_no_batch",
                           "nested"}


def test_frozen_model_builds_no_graph_and_trainable_reaches_the_stack():
    """Frozen (serving), the forward builds no graph; trainable, the
    stacked leaves get their gradient through every layer's row, and
    freezing again restores the views made once."""
    cfg, _, _, model = pair("qwen2-0.5b")
    batch = to_torch(make_batch(cfg, B, S, seed=4))
    logits, _ = forward(model, cfg, tokens=batch["tokens"])
    assert logits.grad_fn is None
    model.trainable()
    loss, _ = loss_fn(model, cfg, batch, remat="none")
    loss.backward()
    wq = model.params.stages.s0_attn_mlp.attn.wq
    assert wq.grad is not None and bool((wq.grad[1] != 0).any())
    model.trainable(False)
    assert not any(p.requires_grad for p in model.parameters())
    assert all(not layer.trainable for layer in model.blocks)
    with torch.no_grad():
        again, _ = forward(model, cfg, tokens=batch["tokens"])
    assert torch.equal(again, logits.detach())
