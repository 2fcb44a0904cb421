"""Sliding-window and packed-sequence models of the port
(taper_tpu_torch/nn/transformer.py, models/transformer.py) against the
JAX package's: RoPE and learned positions at per-token ``[B, S]``
positions; ``TinyGPT(window=)`` and packed ``segment_ids``/``positions``
through ``loss`` with every gradient; W-slot ring caches through prefill
and decode in f32, bf16 and int8, before the ring fills and far past it;
the contiguous serving engine over a window model; and
``examples/train_tinylm.py --window``.

JAX draws the parameters, which reach the port through numpy and
``load_jax_params``; JAX runs on the pallas backend with
``TAPER_FLASH_MIN=128`` so that its flash kernels (interpreted) carry the
window and the segments.  Tolerances as the port's conventions say: f32
rotations 1e-6 (the same products), loss 1e-5 and gradients 1e-4
relative L2; logits 1e-4 in f32, 2e-2 in bf16 and 1e-3 over int8 caches
(test_torch_cache.py gives the reasons).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu import ops as jops
from taper_tpu import optim as joptim
from taper_tpu import serve as jserve
from taper_tpu.data.seq import masked_token_loss as jmasked_token_loss
from taper_tpu.nn import transformer as JT
from taper_tpu_torch.data import pack_documents
from taper_tpu_torch.data.seq import sort_task_batch
from taper_tpu_torch.examples import train_tinylm
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.nn import transformer as T
from taper_tpu_torch.serve import ServingEngine
from taper_tpu_torch.utils.convert import _flatten, load_jax_params

torch.set_num_threads(1)

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
LOGIT_TOL = {"f32": 1e-4, "bf16": 2e-2, "int8": 1e-3}


def _positions(b=2, s=20, seed=0):
    """Per-token positions that restart at document starts."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((b, s), np.int32)
    for r in range(b):
        starts = sorted(rng.choice(np.arange(1, s), 2, replace=False))
        at = 0
        for z in list(starts) + [s]:
            pos[r, at:z] = np.arange(z - at)
            at = z
    return pos


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_rope_at_token_positions_matches_jax(layout):
    cos, sin = JT.rope_angles(16, 32)
    tcos, tsin = T.rope_angles(16, 32)
    pos = _positions()
    x = np.random.default_rng(1).standard_normal(
        (2, 3, 20, 16) if layout == "bhsd" else (2, 20, 48)).astype(
            np.float32)
    if layout == "bhsd":
        ref = JT.apply_rope(jnp.asarray(x), cos, sin, jnp.asarray(pos))
        out = T.apply_rope(torch.from_numpy(x), tcos, tsin,
                           torch.from_numpy(pos))
    else:
        ref = JT.apply_rope_bshd(jnp.asarray(x), cos, sin, 3,
                                 jnp.asarray(pos))
        out = T.apply_rope_bshd(torch.from_numpy(x), tcos, tsin, 3,
                                torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def _case(seed, s, **cfg):
    cfg = dict(vocab_size=32, depth=2, max_seq=s, **cfg)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**cfg),
                            jax.tree.map(np.asarray, params))
    return jmodel, params, model


def _packed_batch(s, seed):
    rng = np.random.default_rng(seed)
    docs = [list(rng.integers(1, 32, int(n)))
            for n in rng.integers(10, 90, 7)]
    p = pack_documents(docs, s)
    return {k: v[:2] for k, v in p.items()}


@pytest.mark.parametrize("dim,heads,cfg,packed", [
    (64, 2, dict(rope=True, window=48), False),
    (64, 4, dict(rope=True, window=20, num_kv_heads=2), False),
    (256, 2, dict(rope=True, window=40), False),
    (64, 2, dict(rope=True), True),
    (64, 2, dict(rope=False), True),
], ids=["window-rope", "window-gqa", "window-bshd", "packed-rope",
        "packed-learned-positions"])
def test_loss_and_grads_match_jax(monkeypatch, dim, heads, cfg, packed):
    """``TinyGPT(window=)`` and packed batches (segment ids, per-document
    positions) through ``loss`` and autograd against JAX's
    ``value_and_grad``; head dim 128 takes the ``[B, S, H*D]`` path."""
    monkeypatch.setenv("TAPER_FLASH_MIN", "128")
    s = 128
    jmodel, params, model = _case(dim + heads, s, dim=dim, num_heads=heads,
                                  **cfg)
    if packed:
        p = _packed_batch(s, dim)
        toks, tgts, mask = p["tokens"], p["targets"], p["loss_mask"]
        extra = {n: p[n] for n in ("segment_ids", "positions")}
    else:
        rng = np.random.default_rng(dim)
        toks = rng.integers(0, 32, (2, s)).astype(np.int32)
        tgts = np.roll(toks, -1, 1)
        mask = np.ones((2, s), np.float32)
        extra = {}

    def jloss(pr):
        return jmodel.loss(pr, jnp.asarray(toks), jnp.asarray(tgts),
                           jnp.asarray(mask),
                           **{n: jnp.asarray(x) for n, x in extra.items()})

    with jops.use_backend("pallas"):
        (ref, _), g_ref = jax.value_and_grad(jloss, has_aux=True)(params)
    g_ref = dict(_flatten(jax.tree.map(np.asarray, g_ref)))
    loss, _ = model.loss(torch.from_numpy(toks).long(),
                         torch.from_numpy(tgts).long(),
                         torch.from_numpy(mask),
                         **{n: torch.from_numpy(x) for n, x in extra.items()})
    loss.backward()
    assert abs(loss.item() - float(ref)) <= LOSS_TOL * abs(float(ref))
    total = np.sqrt(sum(np.sum(np.square(r)) for r in g_ref.values()))
    for k, p in model.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        if k.endswith("attn.bk") and not cfg["rope"]:
            # zero in exact arithmetic without rope: rounding noise only
            assert max(np.linalg.norm(g), np.linalg.norm(g_ref[k])) \
                <= 1e-6 * total, k
            continue
        rel = np.linalg.norm(g - g_ref[k]) / max(np.linalg.norm(g_ref[k]),
                                                  1e-30)
        assert rel <= GRAD_TOL, (k, rel)


def test_packed_document_equals_the_document_alone():
    """The property packing exists for: a document packed with others
    gets the logits it gets alone (positions restart, segments mask)."""
    model = TinyGPT(vocab_size=37, dim=32, depth=2, num_heads=4,
                    max_seq=64, rope=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    d1, d2 = list(rng.integers(1, 37, 5)), list(rng.integers(1, 37, 7))
    p = {k: torch.from_numpy(v) for k, v in
         pack_documents([d1, d2], 16).items()}
    with torch.no_grad():
        packed = model(p["tokens"].long(), p["segment_ids"], p["positions"])
        for doc, start in ((d1, 0), (d2, 5)):
            alone = model(torch.tensor([doc]))
            torch.testing.assert_close(packed[0, start:start + len(doc)],
                                       alone[0], rtol=1e-5, atol=1e-5)


W, SMAX = 6, 24


def _ring_models(kind, **kw):
    cfg = dict(vocab_size=48, dim=32, depth=2, num_heads=4, max_seq=SMAX,
               window=W, **kw)
    bf16 = kind == "bf16"
    jmodel = jmodels.TinyGPT(**cfg, compute_dtype=jnp.bfloat16 if bf16
                             else None)
    params = jmodel.init(jax.random.PRNGKey(7))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray,
                                                         params))
    if bf16:
        model.compute_dtype = torch.bfloat16
    return jmodel, params, model


@pytest.mark.parametrize("kind,kw,prompt_len,rows", [
    ("f32", dict(rope=True, num_kv_heads=2), 4, False),
    ("f32", dict(rope=False), 10, True),
    ("bf16", dict(rope=True), 10, False),
    ("int8", dict(rope=True, num_kv_heads=2), 10, True),
    ("int8", dict(rope=False), 3, False)])
@torch.no_grad()
def test_ring_cache_matches_jax_and_the_full_cache(kind, kw, prompt_len,
                                                   rows):
    """A two-row prefill shorter or longer than W (the latter wraps the
    ring during the prefill), then decode steps from inside the first W
    positions to far past W, with argmax feedback: the ring's logits and
    slots against JAX's ring cache, and its logits against the full
    cache's (the same model with the window mask)."""
    jmodel, params, model = _ring_models(kind, **kw)
    quant = kind == "int8"
    prompt = np.random.default_rng(3).integers(0, 48, (2, prompt_len))
    tol = LOGIT_TOL[kind]
    with jops.use_backend("pallas"):
        jc = jmodel.init_cache(2, quantized=quant, ring=True)
        ref, jc = jax.jit(jmodel.prefill)(
            params, jnp.asarray(prompt, jnp.int32), jc)
        ring = model.init_cache(2, quantized=quant, ring=True)
        full = model.init_cache(2, quantized=quant)
        assert ring[0]["k"].shape[2] == W
        out = model.prefill(torch.from_numpy(prompt), ring)
        out_full = model.prefill(torch.from_numpy(prompt), full)
        for o in (out, out_full):
            np.testing.assert_allclose(o.numpy(), np.asarray(ref), rtol=tol,
                                       atol=tol)
        step = jax.jit(jmodel.decode_step)
        pos = np.full(2, prompt_len, np.int32)
        if rows:
            pos[1] -= 1
        tok = np.asarray(ref)[:, -1].argmax(-1)
        for _ in range(SMAX - prompt_len - 1):
            p_arg = pos if rows else pos[0]
            ref, jc = step(params, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(p_arg, jnp.int32), jc)
            tp = torch.from_numpy(pos) if rows else int(pos[0])
            out = model.decode_step(torch.from_numpy(tok), tp, ring)
            out_full = model.decode_step(torch.from_numpy(tok), tp, full)
            for o in (out, out_full):
                np.testing.assert_allclose(o.numpy(), np.asarray(ref),
                                           rtol=tol, atol=tol)
            tok, pos = np.asarray(ref).argmax(-1), pos + 1
    for c, j in zip(ring, jc):
        for name in c:
            got = c[name].float().numpy()
            want = np.asarray(j[name].astype(jnp.float32))
            if quant and not name.endswith("scale"):
                assert np.abs(got - want).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_ring_slots_hold_the_last_window():
    """``_cache_write(ring=True)``: position p in slot p % W; a prefill of
    C > W rows keeps the last W; per-row positions wrap each row."""
    cache = {"k": torch.zeros(2, 1, 4, 1), "v": torch.zeros(2, 1, 4, 1)}
    rows = torch.arange(10.0).reshape(1, 1, 10, 1).repeat(2, 1, 1, 1)
    T._cache_write(cache, rows, rows, 0, ring=True)
    assert cache["k"][0, 0, :, 0].tolist() == [8.0, 9.0, 6.0, 7.0]
    one = torch.tensor([[[[50.0]]], [[[60.0]]]])
    T._cache_write(cache, one, one, torch.tensor([10, 13]), ring=True)
    assert cache["k"][0, 0, :, 0].tolist() == [8.0, 9.0, 50.0, 7.0]
    assert cache["k"][1, 0, :, 0].tolist() == [8.0, 60.0, 6.0, 7.0]


def test_window_models_refuse_paged_caches_and_serve_contiguous():
    """Paged caches refuse a window model (JAX asserts); the contiguous
    engine serves it through the full cache with the window mask, token
    for token as JAX's engine."""
    jmodel, params, model = _ring_models("f32", rope=True)
    with pytest.raises(ValueError, match="paged"):
        model.init_paged_cache(4, 8)
    with pytest.raises(ValueError, match="paged"):
        model.prefill_paged(torch.zeros(1, 4, dtype=torch.long), [], None)
    with pytest.raises(ValueError, match="window"):
        TinyGPT(vocab_size=8, dim=16, depth=1, num_heads=2,
                max_seq=16).init_cache(1, ring=True)
    prompts = [list(range(1, 6)), list(range(3, 12)), [7, 7]]
    max_new = [9, 5, 12]
    kw = dict(slots=2, prompt_pad=12, decode_block=3)
    eng = ServingEngine(model, device="cpu", **kw)
    ids = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
    out = eng.run()
    with jops.use_backend("pallas"):
        jeng = jserve.ServingEngine(jmodel, params, **kw)
        jids = [jeng.submit(p, m) for p, m in zip(prompts, max_new)]
        ref = jeng.run()
    assert [out[i] for i in ids] == [ref[i] for i in jids]
    assert [len(out[i]) for i in ids] == max_new


def test_train_tinylm_window_matches_jax():
    """``train_tinylm --window`` on the CPU: three steps of the example's
    step function against JAX's TinyGPT(window=) with JAX's Adam on the
    same batches and initial weights (the port's batches, drawn from its
    generator, fed to both): the loss at every step.  JAX runs its XLA
    attention here, which masks the window as its flash kernel does (the
    kernel is held above)."""
    args = train_tinylm.parse_args(
        ["--device", "cpu", "--window", "16", "--dim", "32", "--batch", "4",
         "--steps", "3"])
    model, opt = train_tinylm.build(args)
    jmodel = jmodels.TinyGPT(vocab_size=12, dim=32, depth=2, num_heads=2,
                             max_seq=128, window=16)
    params = jmodel.init(jax.random.PRNGKey(0))
    load_jax_params(model, jax.tree.map(np.asarray, params))
    jopt = joptim.Adam(1e-3, weight_decay=0.0)
    state = jopt.init(params)
    step = train_tinylm.make_step(model, opt, args,
                                  torch.Generator().manual_seed(1))
    batches = torch.Generator().manual_seed(1)

    def jloss(p, toks, tgts, mask):
        logits = jmodel.apply(p, toks)
        return jmasked_token_loss(logits, tgts, mask)

    with jops.use_backend("xla"):
        grad_fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        for _ in range(3):
            toks, tgts, mask = (jnp.asarray(t.numpy()) for t in
                                sort_task_batch(args.batch, args.length,
                                                generator=batches))
            (ref, _), grads = grad_fn(params, toks.astype(jnp.int32),
                                      tgts.astype(jnp.int32), mask)
            params, state = jopt.update(grads, state, params)
            loss, _ = step()
            assert abs(float(loss) - float(ref)) <= 1e-4 * abs(float(ref)), (
                float(loss), float(ref))
