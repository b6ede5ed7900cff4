"""The port's serving over a device mesh, and its elastic checkpoint
restore, against world size 1 and the JAX package's checkpoints.

Gloo ranks on the CPU (``tests/_torch_dist_jobs.py``), one spawn per
world size.  Serving: reduced configs from seed-0 weights, 4 prompts of
16 tokens, 4 generated tokens; ``serve_batch(mesh=)`` gives the tokens of
world size 1, and the prefill step's and a decode step's logits,
gathered over the data ranks, are within 1e-5 of world size 1's (fp32;
the MoE model routes over the data group, so it drops and orders as one
device does; over a (1, 4) mesh it runs the expert-parallel layer, two
experts a rank, whose one data shard routes the whole batch).  Elastic restore (the port of the reference's
``test_elastic_checkpoint_restore_across_meshes`` at world size 4 in
place of 8): ``train_loop`` on a (2, 2) mesh checkpoints after step 2;
launches on (4, 1) and (1, 4) restore it and run step 3, whose loss is
within 1e-4 of the uninterrupted run's; the files are byte for byte a
world-size-1 save of the same state, and the JAX package's
``restore_checkpoint`` reads them.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _torch_dist_jobs as jobs  # noqa: E402

MOE = "deepseek-moe-16b"
SERVE = [("qwen3-0.6b", (2, 1)), (MOE, (2, 1)), ("qwen3-0.6b", (2, 2)), (MOE, (1, 4))]
RESTORE = [(4, 1), (1, 4)]


# world size 1, computed in the spawned ranks after their mesh work
PLAIN = [(a, jobs.serve_one, (a,), {}) for a in sorted({a for a, _ in SERVE})]


@pytest.fixture(scope="module")
def ws2():
    results = jobs.run_world(2, jobs.in_order, [
        (jobs.serve_cases, ([((a, s), a, s) for a, s in SERVE if s == (2, 1)],)),
        (jobs.spread, (PLAIN,))])
    return [r[0] for r in results], jobs.merged(r[1] for r in results)


@pytest.fixture(scope="module")
def ws4(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic"))
    serve, elastic, plain = jobs.run_world(4, jobs.in_order, [
        (jobs.serve_cases, ([((a, s), a, s) for a, s in SERVE if s != (2, 1)],)),
        (jobs.elastic, (root, (2, 2), RESTORE)),
        (jobs.spread, ([("one", jobs.plain_run, (os.path.join(root, "one"),), {})],))])[0]
    return serve, elastic, root, plain["one"]


@pytest.mark.parametrize("arch,shape", SERVE, ids=[f"{a}-{s[0]}x{s[1]}" for a, s in SERVE])
def test_serving_on_a_mesh_equals_world_size_1(ws2, ws4, arch, shape):
    got = (ws2[0][0] if shape == (2, 1) else ws4[0])[(arch, shape)]
    want = ws2[1][arch]
    assert got["tokens"].shape == (4, 4) and got["tokens"].dtype == np.int32
    assert np.array_equal(got["tokens"], want["tokens"])
    for k in ("prefill", "decode"):
        assert got[k].shape == want[k].shape
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5, msg=k)


def test_every_rank_serves_the_same_tokens(ws2):
    results = ws2[0]
    for key in results[0]:
        for res in results[1:]:
            assert np.array_equal(res[key]["tokens"], results[0][key]["tokens"]), key


@pytest.mark.parametrize("shape", RESTORE, ids=[f"{s[0]}x{s[1]}" for s in RESTORE])
def test_elastic_restore_onto_another_mesh_continues(ws4, shape):
    elastic = ws4[1]
    assert len(elastic["first"]) == 3
    run = elastic[shape]
    assert run["restored_from"] == 2 and len(run["losses"]) == 1
    assert run["losses"][0] == pytest.approx(elastic["first"][2], rel=0, abs=1e-4)


def test_sharded_run_matches_world_size_1_and_saves_its_bytes(ws4):
    """The (2, 2) run's losses are world size 1's (1e-5 relative), its
    step-2 checkpoint holds world size 1's state (parameters within 1e-4,
    the same leaves, shapes and dtypes), and its files are byte for byte
    what the one-device path writes for the same state."""
    _, elastic, root, plain = ws4
    np.testing.assert_allclose(elastic["first"], plain, rtol=1e-5)
    sharded = os.path.join(root, "first", "step_00000002")
    one = os.path.join(root, "one", "step_00000002")
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(one))
    for name in os.listdir(sharded):
        if name.endswith(".npy"):
            a, b = np.load(os.path.join(sharded, name)), np.load(os.path.join(one, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
    again = os.path.join(root, "plain", "step_00000002")
    for name in os.listdir(sharded):
        with open(os.path.join(sharded, name), "rb") as f, open(os.path.join(again, name),
                                                                "rb") as g:
            assert f.read() == g.read(), name


def test_the_reference_restores_a_sharded_checkpoint(ws4):
    import jax

    from repro.checkpoint.manager import restore_checkpoint as jrestore
    from repro.configs import get_config as jget_config
    from repro.models import lm as jlm
    from repro.optim.adamw import adamw as jadamw
    from repro_torch.checkpoint.manager import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import lm
    root = ws4[2]
    params = jlm.init_params(jget_config("qwen3-0.6b", reduced=True), jax.random.PRNGKey(0))
    target = {"params": params, "opt": jadamw(1e-3).init(params)}
    theirs, step = jrestore(os.path.join(root, "first"), target, step=2)
    assert step == 2
    model = lm.init_params(get_config("qwen3-0.6b", reduced=True), seed=0, device="cpu")
    from repro_torch.optim.adamw import adamw
    mine, _ = restore_checkpoint(os.path.join(root, "first"),
                                 train.state_tree(model, adamw(1e-3).init(
                                     dict(model.named_parameters()))), step=2)
    flat_theirs = jax.tree_util.tree_flatten_with_path(theirs)[0]
    flat_mine = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), mine))[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_theirs] == \
        [jax.tree_util.keystr(p) for p, _ in flat_mine]
    for (path, a), (_, b) in zip(flat_theirs, flat_mine):
        assert np.array_equal(np.asarray(a), b), jax.tree_util.keystr(path)
