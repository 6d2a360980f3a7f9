"""The port's language-model stack against the reference on the CPU:
the attention architectures (dense GQA, MLA, the vision prefix).

For each architecture at ``build_small(name, n_layers=2)``, on the
reference's own weights carried across by ``models/convert.py``:
forward logits and aux at batch 2 x seq 16, and the prefill plus two
decode steps with their caches, in f32 compute within 1e-4 of
max|reference|; ``deepseek-7b`` also in its bf16 compute within 3e-2
(``torch_lm_ref.BF16_TOL``); the chunked running softmax (``kv_chunk``)
against the reference's plain softmax; ``param_count`` and
``launch.train.scaled_config`` equal to the reference's; the port's own
initial weights with the reference's names, shapes and scales; and the
registry with its shape cells and skip reasons.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro_torch import configs
from repro_torch.models import model as TM
from repro_torch.models import steps
from torch_lm_ref import (BF16_TOL, F32_TOL, S, Arch, check_arch,
                          check_config, check_init, port_run, reference_run,
                          rel_err)
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ("deepseek-7b", "deepseek-67b", "minitron-4b", "minicpm3-4b",
         "phi-3-vision-4.2b")


@pytest.fixture(scope="module")
def archs():
    """name -> :class:`torch_lm_ref.Arch`, each built once."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = Arch(name)
        return built[name]
    return get


@pytest.mark.parametrize("name", NAMES)
def test_forward_prefill_decode_f32(archs, name):
    check_arch(archs(name))


@pytest.mark.parametrize("name", ("deepseek-7b", "minicpm3-4b"))
def test_kv_chunk_running_softmax(archs, name):
    """Chunks of 8 over the 16 keys: the streamed softmax equals the
    reference's one-pass softmax."""
    a = archs(name)
    logits, _ = port_run(a.cfg, a.tree, a.x, decode=False, kv_chunk=8)
    assert rel_err(logits, a.ref[0]) <= F32_TOL


def test_forward_bf16_deepseek(archs):
    a = archs("deepseek-7b")
    cfg = dataclasses.replace(a.cfg, compute_dtype="bfloat16")
    want, _ = reference_run(cfg, a.params, a.x, decode=False)
    got, _ = port_run(cfg, a.tree, a.x, decode=False)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("name", NAMES)
def test_config_counts(name):
    check_config(name)


@pytest.mark.parametrize("name", NAMES)
def test_init_shapes_and_scales(archs, name):
    check_init(archs(name))


def test_registry_and_shape_cells():
    assert configs.ARCH_NAMES == rconfigs.ARCH_NAMES
    assert [dataclasses.asdict(s) for s in configs.SHAPES] == \
        [dataclasses.asdict(s) for s in rconfigs.SHAPES]
    assert sorted(configs.SHAPE_BY_NAME) == sorted(rconfigs.SHAPE_BY_NAME)
    for name in configs.ARCH_NAMES:
        ours = [(c.name, why) for c, why in configs.shapes_for(
            configs.get(name))]
        theirs = [(c.name, why) for c, why in rconfigs.shapes_for(
            rconfigs.get(name))]
        assert ours == theirs
    with pytest.raises(KeyError):
        configs.get("no-such-arch")
    # the QCD half of the package is unchanged
    assert configs.get_qcd("wilson-8x8x8x8").shape == (8, 8, 8, 8)
    assert {k: dataclasses.asdict(v) for k, v in
            configs.QCD_CONFIGS.items()} == \
        {k: dataclasses.asdict(v) for k, v in rconfigs.QCD_CONFIGS.items()}


def test_module_and_serving_steps(archs):
    """``LanguageModel`` registers the tree as parameters (no copies) and
    its methods are the functional entry points; ``make_prefill_step``
    and ``make_serve_step`` (bf16 cache) against the reference's
    prefill and first decode step (f32 cache)."""
    a = archs("phi-3-vision-4.2b")
    model = TM.LanguageModel(a.cfg, a.tree, device="cpu")
    flat = TM.flatten(a.tree)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(flat)
    assert all(named[k].data_ptr() == flat[k].data_ptr() for k in flat)
    x = {k: torch.from_numpy(v) for k, v in a.x.items()}
    toks = x.pop("tokens")
    with torch.no_grad():
        got, _ = model(toks[:, :S], **x)
        np.testing.assert_array_equal(
            got.numpy(), TM.forward(a.cfg, a.tree, toks[:, :S],
                                    **x)[0].numpy())
        prefill = steps.make_prefill_step(a.cfg, S + 4 +
                                          a.cfg.num_prefix_embeds)
        last, cache, idx = prefill(model.params(),
                                   {"tokens": toks[:, :S], **x})
        nxt, logits, cache = steps.make_serve_step(a.cfg)(
            model.params(), cache, toks[:, S:S + 1], idx)
    assert cache[0]["k"].dtype == torch.bfloat16
    assert rel_err(last, a.ref[2]) <= F32_TOL
    assert rel_err(logits, a.ref[3]) <= BF16_TOL
    assert torch.equal(nxt[:, 0], torch.argmax(logits[:, -1], dim=-1))
