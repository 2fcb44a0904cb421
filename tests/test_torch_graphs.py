"""The decode programs' store and generators (taper_tpu_torch/utils/graphs.py)
on the CPU, where a step runs its function eagerly.

A loop's program is kept on the model that owns it, keyed by its static
configuration and never by the caller's generator: the program draws from
a generator of its own, which takes the caller's state before the loop
and gives it back after.  Small f32 models from fixed seeds.
"""

import copy
import gc
import weakref

import numpy as np
import torch

from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.serve import ServingEngine, offline_serve
from taper_tpu_torch.utils import graphs

torch.set_num_threads(1)

CFG = dict(vocab_size=32, dim=32, depth=2, num_heads=4, max_seq=64,
           rope=True)


def _model(seed=0):
    model = TinyGPT(**CFG)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()


def _prompt(b=2, p=6, seed=1):
    return torch.randint(0, CFG["vocab_size"], (b, p),
                         generator=torch.Generator().manual_seed(seed))


def test_programs_are_kept_on_their_model():
    """A generate call leaves its program on its model alone; a copy of
    the model starts with none; clear drops them."""
    a, b = _model(), _model()
    a.generate(_prompt(), 5)
    assert len(graphs.programs(a)) == 1 and graphs.programs(b) == []
    assert graphs.programs(copy.deepcopy(a)) == []
    graphs.clear(a)
    assert graphs.programs(a) == []


def test_programs_go_with_their_model():
    """Deleting a model frees its programs with it (their steps refer
    back to the model: the cycle goes at a collection)."""
    model = _model()
    model.generate(_prompt(), 5)
    model.beam_search(_prompt(), 4, beams=2)
    held = weakref.ref(graphs.programs(model)[0])
    gone = weakref.ref(model)
    del model
    gc.collect()
    assert gone() is None and held() is None


def test_the_store_is_bounded_least_recent_first():
    """At most MAX_PROGRAMS programs a model, the least recently used
    dropped first; a repeated configuration reuses its program."""
    model = _model()
    prompt = _prompt()
    for n in range(2, 4 + graphs.MAX_PROGRAMS):
        model.generate(prompt, n)
    progs = graphs.programs(model)
    assert len(progs) == graphs.MAX_PROGRAMS
    model.generate(prompt, 3 + graphs.MAX_PROGRAMS)     # the newest again
    assert graphs.programs(model)[-1] is progs[-1]
    model.generate(prompt, 2)                           # dropped: rebuilt
    assert graphs.programs(model)[0] is progs[1]


def test_a_fresh_generator_each_call_takes_one_program():
    """Sampled calls, each from a new generator: one program, and the
    same seed draws the same tokens."""
    model = _model()
    prompt = _prompt()
    outs = [model.generate(prompt, 8, temperature=0.9,
                           generator=torch.Generator().manual_seed(s))
            for s in (3, 4, 3)]
    assert len(graphs.programs(model)) == 1
    assert torch.equal(outs[0], outs[2]) and not torch.equal(outs[0],
                                                             outs[1])


def test_the_callers_generator_advances_as_an_eager_loop():
    """The caller's generator ends where the token-at-a-time loop, which
    draws from it directly, leaves it, after the same tokens; a second
    call from it draws on."""
    model = _model()
    prompt = _prompt()
    g_prog, g_eager = (torch.Generator().manual_seed(5) for _ in range(2))
    first = model.generate(prompt, 8, temperature=0.9, generator=g_prog)
    ref = model.generate(prompt, 8, temperature=0.9, generator=g_eager,
                         one_shot_prefill=False)
    assert torch.equal(first, ref)
    assert torch.equal(g_prog.get_state(), g_eager.get_state())
    second = model.generate(prompt, 8, temperature=0.9, generator=g_prog)
    assert not torch.equal(first, second)


def test_speculative_sampling_carries_the_callers_generator():
    """Sampled speculative decoding: the caller's generator advances over
    a call (the next call draws others), a reseeded one repeats it, and a
    fresh generator each call keeps one program."""
    target, draft = _model(0), _model(1)
    prompt = _prompt()
    gen = torch.Generator().manual_seed(7)
    kw = dict(gamma=3, temperature=0.8)
    first = target.speculative_generate(draft, prompt, 10, generator=gen,
                                        **kw)
    second = target.speculative_generate(draft, prompt, 10, generator=gen,
                                         **kw)
    again = target.speculative_generate(
        draft, prompt, 10, generator=torch.Generator().manual_seed(7), **kw)
    assert torch.equal(first, again) and not torch.equal(first, second)
    assert len(graphs.programs(target)) == 1


def test_offline_serve_keeps_one_engine_per_setting():
    """offline_serve's engine is kept on the model: a repeated call with
    the same settings reuses it and gives the same tokens; another slot
    count builds another."""
    model = _model()
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, CFG["vocab_size"], (5, 6))
    lens, budgets = [6, 3, 5, 4, 6], [4, 7, 2, 5, 3]
    out, n_tok = offline_serve(model, prompts, lens, budgets, slots=2,
                               device="cpu")
    (eng,) = graphs.programs(model)
    assert isinstance(eng, ServingEngine)
    again, _ = offline_serve(model, prompts, lens, budgets, slots=2,
                             device="cpu")
    assert torch.equal(out, again) and graphs.programs(model) == [eng]
    offline_serve(model, prompts, lens, budgets, slots=3, device="cpu")
    assert len(graphs.programs(model)) == 2
    assert n_tok.tolist() == budgets


def test_engine_draws_from_the_callers_generator():
    """ServingEngine(generator=g) samples from g: the tokens of an engine
    seeded the same, and g advanced."""
    model = _model()
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]

    def run(**kw):
        eng = ServingEngine(model, slots=2, prompt_pad=8, decode_block=3,
                            temperature=0.9, device="cpu", **kw)
        ids = [eng.submit(p, 6) for p in prompts]
        out = eng.run()
        return [out[i] for i in ids]
    gen = torch.Generator().manual_seed(9)
    start = gen.get_state()
    assert run(generator=gen) == run(seed=9)
    assert not torch.equal(gen.get_state(), start)
