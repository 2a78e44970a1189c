"""The port's MoE FFN (``repro_torch.models.moe``) and the two MoE
architectures (deepseek-v2 with MLA and shared experts, mixtral with
SWA) against the JAX package on the CPU, from the same numpy-seeded
inputs. The model-level cases reuse ``tests/test_torch_lm.py``'s helpers
and tolerances (its docstring states them).

``moe_ffn`` and ``moe_ffn_vsharded`` run with drops forced
(``capacity_factor`` 0.5: each expert's capacity is below its load). At
f32: the routing (top-k experts) equal, outputs and aux rtol 1e-5 with
an atol of 1e-5 of the largest magnitude, gradients (x, router, the
three expert stacks) rtol 1e-4 with an atol of 1e-4 of the leaf's
largest magnitude. At bf16 (x and experts bf16, the router f32 as the
reference keeps it): the router reads ``x.astype(f32)``, so the gates
differ only by f32 summation order; a token whose k-th and (k+1)-th
gates are within 1e-6 may route either way, and only such a token may
route differently (the flips are counted; a flip moves the slots of its
experts' other tokens, so outputs are compared on tokens whose experts
no flipped token touches); outputs atol 2**-6 of the
largest magnitude (two bf16 ulps; the reference runs in process here,
where XLA may keep f32 between ops).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import moe as rmoe
from repro_torch.models import moe as pmoe
from repro_torch.models.recsys import topk

from test_torch_lm import (_start_bf16, bf16_proc, bf16_ref,  # noqa: F401
                           check_against_reference, close, f32)

ARCHS = ("deepseek-v2-236b", "mixtral-8x7b")  # bf16_proc's archs here
T, D, E, FE, K = 128, 16, 4, 32, 2


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_moe_lm_matches_reference(arch, cdt, request):
    check_against_reference(arch, cdt, request)


def moe_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32)
    w1, w3 = (rng.standard_normal((E, D, FE)).astype(np.float32) * 0.1
              for _ in range(2))
    w2 = rng.standard_normal((E, FE, D)).astype(np.float32) * 0.1
    r = rng.standard_normal((T, D)).astype(np.float32)
    return x, router, w1, w3, w2, r


def run_both(vs, x, router, w1, w3, w2, r):
    """(out, aux, grads) of the reference and of the port, the loss
    ``sum(out * r) + aux`` differentiated in x, router, w1, w3, w2."""
    kw = dict(top_k=K, capacity_factor=0.5)
    if vs:
        ref_f = lambda *a: rmoe.moe_ffn_vsharded(  # noqa: E731
            *a, n_virtual_shards=vs, **kw)
        port_f = lambda *a: pmoe.moe_ffn_vsharded(  # noqa: E731
            *a, n_virtual_shards=vs, **kw)
    else:
        ref_f = lambda *a: rmoe.moe_ffn(*a, ep_on_model=False,  # noqa: E731
                                        **kw)
        port_f = lambda *a: pmoe.moe_ffn(*a, ep_on_model=False,  # noqa: E731
                                         **kw)

    def ref_loss(*a):
        out, aux = ref_f(*a)
        return jnp.sum(out.astype(jnp.float32) * r) + aux, (out, aux)
    (_, (ro, ra)), rg = jax.value_and_grad(ref_loss, argnums=range(5),
                                           has_aux=True)(
        *map(jnp.asarray, (x, router, w1, w3, w2)))
    args = [torch.from_numpy(a).requires_grad_()
            for a in (x, router, w1, w3, w2)]
    po, pa = port_f(*args)
    pg = torch.autograd.grad((po.float() * torch.from_numpy(r)).sum() + pa,
                             args)
    return (ro, ra, rg), (po, pa, pg)


@pytest.mark.parametrize("vs", [0, 4])
def test_moe_f32_matches_reference(vs):
    x, router, w1, w3, w2, r = moe_inputs(vs)
    gates = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, ref_topi = jax.lax.top_k(gates, K)
    _, port_topi = topk(torch.softmax(torch.from_numpy(x)
                                      @ torch.from_numpy(router), -1), K)
    assert np.array_equal(port_topi.numpy(), np.asarray(ref_topi))
    # drops are forced: some expert's load exceeds its capacity
    t_loc = T // max(vs, 1)
    c = pmoe.moe_capacity(t_loc, E, K, 0.5)
    loads = np.bincount(np.asarray(ref_topi)[:t_loc].ravel(), minlength=E)
    assert c == rmoe.moe_capacity(t_loc, E, K, 0.5) and loads.max() > c
    (ro, ra, rg), (po, pa, pg) = run_both(vs, x, router, w1, w3, w2, r)
    close(f32(po), f32(ro), 1e-5, 1e-5)
    close(f32(pa), f32(ra), 1e-5, 1e-5)
    for a, b in zip(pg, rg):
        close(f32(a), f32(b), 1e-4, 1e-4)


@pytest.mark.parametrize("vs", [0, 4])
def test_moe_bf16_matches_reference(vs):
    x, router, w1, w3, w2, r = moe_inputs(10 + vs)
    bf = lambda a: f32(jnp.asarray(a).astype(jnp.bfloat16))  # noqa: E731
    xb, w1b, w3b, w2b = map(bf, (x, w1, w3, w2))
    kw = dict(top_k=K, capacity_factor=0.5)
    if vs:
        ro, ra = rmoe.moe_ffn_vsharded(
            *(jnp.asarray(a).astype(jnp.bfloat16) if i != 1
              else jnp.asarray(a) for i, a in enumerate(
                  (xb, router, w1b, w3b, w2b))), n_virtual_shards=vs, **kw)
    else:
        ro, ra = rmoe.moe_ffn(
            *(jnp.asarray(a).astype(jnp.bfloat16) if i != 1
              else jnp.asarray(a) for i, a in enumerate(
                  (xb, router, w1b, w3b, w2b))), ep_on_model=False, **kw)
    targs = [torch.from_numpy(a).bfloat16() if i != 1
             else torch.from_numpy(a)
             for i, a in enumerate((xb, router, w1b, w3b, w2b))]
    f = (pmoe.moe_ffn_vsharded if vs else pmoe.moe_ffn)
    extra = dict(n_virtual_shards=vs) if vs else dict(ep_on_model=False)
    po, pa = f(*targs, **extra, **kw)
    assert po.dtype == torch.bfloat16
    # routing: flips only where the gates are within 1e-6 (counted);
    # a flip moves the slots of its experts' other tokens
    rg = jax.nn.softmax(jnp.asarray(xb) @ jnp.asarray(router), axis=-1)
    ref_topi = np.asarray(jax.lax.top_k(rg, K)[1])
    port_topi = topk(torch.softmax(targs[0].float() @ targs[1], -1),
                     K)[1].numpy()
    srt = np.sort(np.asarray(rg), axis=-1)
    unsure = srt[:, -K] - srt[:, -K - 1] <= 1e-6
    flips = (np.sort(ref_topi, 1) != np.sort(port_topi, 1)).any(1)
    assert not (flips & ~unsure).any()
    touched = set(ref_topi[flips].ravel()) | set(port_topi[flips].ravel())
    keep = np.array([not (set(ref_topi[t]) & touched) for t in range(T)])
    assert keep.sum() >= T // 2, (int(unsure.sum()), int(flips.sum()))
    close(f32(po)[keep], f32(ro)[keep], 0, 2 ** -6)
    close(f32(pa), f32(ra), 1e-5, 0)


def test_topk_ties_and_combine_order():
    """Ties route to the lower expert (``lax.top_k``); a token's
    contributions add in ascending expert order from zero, in bf16: the
    combine equals that sum computed by hand, bit for bit."""
    g = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])
    assert topk(g, 2)[1].tolist() == [[0, 1], [1, 2]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(g.numpy()), 2)[1]).tolist() \
        == [[0, 1], [1, 2]]
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.standard_normal((E, 8, D)).astype(np.float32)
                         ).bfloat16()
    slot = torch.tensor([[0, 9], [3, -1], [17, 30]])    # -1: dropped
    w = torch.tensor([[0.7, 0.3], [0.6, 0.4], [0.55, 0.45]])
    got = pmoe._combine(y, slot, w, torch.bfloat16)
    yf = y.reshape(E * 8, D)
    for t in range(3):
        want = torch.zeros(D, dtype=torch.bfloat16)
        for j in range(2):
            if slot[t, j] >= 0:
                want = want + yf[slot[t, j]] * w[t, j].bfloat16()
        assert torch.equal(got[t], want)
