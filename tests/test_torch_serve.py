"""The PyTorch port's serving driver against the JAX package's.

``repro_torch.launch.serve.serve_batch(device="cpu")`` and
``repro.launch.serve.serve_batch`` serve qwen3-0.6b, mamba2-780m,
recurrentgemma-9b, deepseek-moe-16b and qwen3-moe-235b-a22b (reduced)
from the same parameters — the JAX
``init_params`` tree for the seed, carried across by ``load_jax_params``
— and the same prompts.  Greedy decoding must pick
the same tokens; the test first checks that every step's top-2 logit
margin is far above the fp32 differences between the two stacks, so a
near-tie cannot decide it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
# fp32 logits of the two stacks differ by ~1e-5 here; a top-2 margin
# above this cannot flip between them
LOGIT_TOL = 1e-3


def _converted(arch, seed):
    tree = jax.tree.map(np.asarray, jlm.init_params(jget_config(arch, reduced=True),
                                                    jax.random.PRNGKey(seed)))
    return convert.load_jax_params(lm.LM(get_config(arch, reduced=True), device="cpu"),
                                 tree)


# each seed's smallest top-2 margin over the served steps clears LOGIT_TOL
# (mamba2's seed 0 has a near-tie of 4e-5)
@pytest.mark.parametrize("arch,seed", [("qwen3-0.6b", 0), ("mamba2-780m", 1),
                                       ("recurrentgemma-9b", 0), ("deepseek-moe-16b", 0),
                                       ("qwen3-moe-235b-a22b", 0)])
def test_serve_batch_matches_jax_tokens(arch, seed):
    kw = dict(batch=2, prompt_len=12, gen_len=5)
    cfg = get_config(arch, reduced=True)
    model = _converted(arch, seed)
    ops.reset_launch_counts()
    mine = serve.serve_batch(cfg, seed=seed, device="cpu", params=model, **kw)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)   # plain versions on the CPU
    assert "logits" not in mine                 # serving keeps only the tokens
    logits = serve.replay_logits(model, serve.make_prompts(cfg, 2, 12, seed), mine["tokens"],
                                 seed=seed)
    assert logits.shape == (2, 5, cfg.vocab_size) and logits.dtype == torch.float32
    top2 = logits.topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > LOGIT_TOL
    assert np.array_equal(mine["tokens"], logits.argmax(-1).numpy())
    want = jserve.serve_batch(jget_config(arch, reduced=True), seed=seed, **kw)
    assert mine["tokens"].shape == (2, 5) and mine["tokens"].dtype == np.int32
    np.testing.assert_array_equal(mine["tokens"], np.asarray(want["tokens"]))
    for key in ("prefill_s", "decode_s", "decode_tokens_per_s"):
        assert mine[key] > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-medium", "internvl2-26b",
                                  "granite-20b"])
def test_make_prompts_matches_jax(arch):
    got = serve.make_prompts(get_config(arch, reduced=True), 3, 10, seed=5)
    want = jserve.make_prompts(jget_config(arch, reduced=True), 3, 10, seed=5)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-26b"])
def test_serve_batch_other_input_modes(arch):
    """Embeds (audio) and prefix-embeds (VLM) serving: right shapes, tokens
    in the vocab, the same tokens twice."""
    cfg = get_config(arch, reduced=True)
    runs = [serve.serve_batch(cfg, batch=2, prompt_len=10, gen_len=4, seed=1, device="cpu")
            for _ in range(2)]
    toks = runs[0]["tokens"]
    assert toks.shape == (2, 4) and toks.min() >= 0 and toks.max() < cfg.vocab_size
    np.testing.assert_array_equal(toks, runs[1]["tokens"])


def test_serve_batch_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("qwen3-0.6b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve_batch(cfg, batch=1, prompt_len=4, gen_len=2)
    with pytest.raises(ValueError):      # a CPU model cannot serve on CUDA
        serve.serve_batch(cfg, batch=1, prompt_len=4, gen_len=2, device="meta",
                          params=lm.init_params(cfg, device="cpu"))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m", "recurrentgemma-9b",
                                  "deepseek-moe-16b"])
def test_serve_cli_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--reduced",
         "--device", "cpu", "--requests", "2", "--prompt-len", "8", "--gen-len", "3"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120, check=True).stdout
    assert '"tokens": [\n  2,\n  3\n ]' in out and "decode_tokens_per_s" in out
