"""CLI + checkpoint tests (ref apps/yelp pipeline, SURVEY §3.1/§3.4)."""

import os

import numpy as np
import pytest

from cdae_jax.cli import main
from cdae_jax.data import io as data_io
from cdae_jax.data.dataset import Interactions, movielens_line_parser
from cdae_jax.models.cdae import CDAE, CDAEConfig
from cdae_jax.models.mf import IMF, MFConfig
from cdae_jax.utils import checkpoint as ckpt


def test_cli_prepare_split_train(tmp_path, movielens_path):
    cache = str(tmp_path / "ml.bin")
    tr_cache = str(tmp_path / "ml.train.bin")
    te_cache = str(tmp_path / "ml.test.bin")
    common = [
        "--cache_file", cache,
        "--train_cache_file", tr_cache,
        "--test_cache_file", te_cache,
        "--parser", "movielens",
    ]
    assert main(["--task", "prepare", "--input_file", movielens_path] + common) == 0
    assert os.path.exists(cache)
    assert main(["--task", "split"] + common) == 0
    assert os.path.exists(tr_cache) and os.path.exists(te_cache)

    ckpt_path = str(tmp_path / "cdae.ckpt")
    rc = main(
        ["--task", "train", "--method", "CDAE", "--num_dim", "6",
         "--max_iters", "3", "--eval_iters", "3", "--batch_size", "32",
         "--skip_popularity", "--checkpoint", ckpt_path] + common
    )
    assert rc == 0
    assert os.path.exists(ckpt_path)

    # test task restores the checkpoint and evaluates
    rc = main(
        ["--task", "test", "--method", "CDAE", "--num_dim", "6",
         "--batch_size", "32", "--skip_popularity",
         "--init_checkpoint", ckpt_path] + common
    )
    assert rc == 0


def test_cli_mf_method(tmp_path, movielens_path):
    cache = str(tmp_path / "ml.bin")
    main(["--task", "prepare", "--input_file", movielens_path,
          "--cache_file", cache, "--parser", "movielens"])
    rc = main(["--task", "train", "--method", "MF", "--num_dim", "4",
               "--max_iters", "2", "--eval_iters", "2", "--batch_size", "64",
               "--skip_popularity", "--cache_file", cache])
    assert rc == 0


def test_cli_pairwise_dense_slab(tmp_path, movielens_path):
    """--dense_mode true reaches the BPR/WARP per-user slab steps from the
    CLI (paired with the 2x-lr cadence compensation, see BASELINE.md)."""
    cache = str(tmp_path / "ml.bin")
    main(["--task", "prepare", "--input_file", movielens_path,
          "--cache_file", cache, "--parser", "movielens"])
    for method in ("BPR", "WARP"):
        rc = main(["--task", "train", "--method", method, "--num_dim", "4",
                   "--max_iters", "2", "--eval_iters", "2",
                   "--batch_size", "16", "--dense_mode", "true",
                   "--learn_rate", "0.2", "--skip_popularity",
                   "--cache_file", cache])
        assert rc == 0


@pytest.mark.parametrize("extra", [
    ["--method", "CDAE", "--num_dim", "6", "--batch_size", "32"],
    ["--method", "BPR", "--num_dim", "4", "--batch_size", "64"],
    ["--method", "BPR", "--num_dim", "4", "--batch_size", "64",
     "--shard_items", "true"],
    ["--method", "ALS"],
])
def test_cli_sharded_train(tmp_path, movielens_path, extra):
    """--sharded wraps --method in its mesh trainer (ShardedCDAE /
    ShardedPairwise / ShardedMFTP / ShardedALS) on the fake 8-dev mesh."""
    cache = str(tmp_path / "ml.bin")
    main(["--task", "prepare", "--input_file", movielens_path,
          "--cache_file", cache, "--parser", "movielens"])
    rc = main(["--task", "train", "--sharded", "true", "--mesh_model", "2",
               "--max_iters", "2", "--eval_iters", "2", "--skip_popularity",
               "--cache_file", cache] + extra)
    assert rc == 0


def test_checkpoint_roundtrip(tmp_path, movielens_path):
    data = Interactions.from_text(movielens_path, movielens_line_parser)
    train, _ = data.split_by_user(0.2, seed=1)
    model = CDAE(CDAEConfig(num_dim=5, batch_size=32, loss="SQUARE"))
    state = model.reset(train, seed=0)
    import jax
    state = model.train_one_iteration(state, jax.random.PRNGKey(0))
    path = str(tmp_path / "m.ckpt")
    ckpt.save_checkpoint(path, state, extra={"method": "CDAE"})
    state2 = model.reset(train, seed=42)  # different init
    state2 = ckpt.load_checkpoint(path, state2)
    assert state2.step == state.step
    for k in state.params:
        np.testing.assert_array_equal(
            np.asarray(state.params[k]), np.asarray(state2.params[k])
        )
    assert ckpt.checkpoint_extra(path)["method"] == "CDAE"


def test_checkpoint_dim_mismatch(tmp_path, movielens_path):
    data = Interactions.from_text(movielens_path, movielens_line_parser)
    train, _ = data.split_by_user(0.2, seed=1)
    model = IMF(MFConfig(num_dim=4, batch_size=32))
    state = model.reset(train, seed=0)
    path = str(tmp_path / "m.ckpt")
    ckpt.save_checkpoint(path, state)
    bad = model.reset(train.with_dims(train.num_users + 1, train.num_items),
                      seed=0)
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(path, bad)


def test_exact_resume_bitwise(tmp_path, movielens_path):
    """resume(ckpt@k) for n−k more epochs is bitwise-identical to an
    unbroken n-epoch run: the checkpoint carries params + AdaGrad
    accumulators + step + the solver's PRNG stream (VERDICT r1 item 8;
    capability superset of ref serialize.hpp:16-46, which never
    checkpoints models at all)."""
    from cdae_jax.solver.solver import Solver

    data = Interactions.from_text(movielens_path, movielens_line_parser)
    train, test = data.split_by_user(0.2, seed=1)

    def make():
        return CDAE(CDAEConfig(num_dim=5, batch_size=32, loss="SQUARE"))

    full = Solver(make(), max_iteration=4, seed=7, verbose=False).train(
        train, test, []
    )

    path = str(tmp_path / "resume.ckpt")
    Solver(make(), max_iteration=2, seed=7, verbose=False).train(
        train, test, [], checkpoint_path=path
    )
    resumed = Solver(make(), max_iteration=4, seed=7, verbose=False).train(
        train, test, [], resume_from=path
    )
    assert resumed.step == full.step == 4
    for k in full.params:
        np.testing.assert_array_equal(
            np.asarray(full.params[k]), np.asarray(resumed.params[k]),
            err_msg=f"param {k} diverged after resume",
        )


def test_exact_resume_sharded_tp(tmp_path, movielens_path):
    """Exact resume holds for the item-sharded TP trainer too: the padded
    P('model') tables round-trip through the checkpoint and the resumed
    run matches an unbroken one (up to the trainer's own float summation
    order, which is deterministic — so bitwise)."""
    from cdae_jax.models.mf import BPR, MFConfig
    from cdae_jax.parallel.mesh import make_mesh
    from cdae_jax.parallel.tp_pairwise import ShardedMFTP
    from cdae_jax.solver.solver import Solver

    data = Interactions.from_text(movielens_path, movielens_line_parser)
    train, test = data.split_by_user(0.2, seed=1)
    mesh = make_mesh(n_data=4, n_model=2)

    def make():
        return ShardedMFTP(
            BPR(MFConfig(num_dim=4, num_neg=2, batch_size=32,
                         dense_mode=False)), mesh=mesh)

    full = Solver(make(), max_iteration=4, seed=7, verbose=False).train(
        train, test, [])
    path = str(tmp_path / "tp_resume.ckpt")
    Solver(make(), max_iteration=2, seed=7, verbose=False).train(
        train, test, [], checkpoint_path=path)
    resumed = Solver(make(), max_iteration=4, seed=7, verbose=False).train(
        train, test, [], resume_from=path)
    assert resumed.step == full.step == 4
    for k in full.params:
        np.testing.assert_array_equal(
            np.asarray(full.params[k]), np.asarray(resumed.params[k]),
            err_msg=f"param {k} diverged after TP resume",
        )


def test_resume_rejects_config_mismatch(tmp_path, movielens_path):
    """A checkpoint written under one config refuses to resume another
    (fingerprint covers model class + config + data dims)."""
    from cdae_jax.solver.solver import Solver

    data = Interactions.from_text(movielens_path, movielens_line_parser)
    train, test = data.split_by_user(0.2, seed=1)
    path = str(tmp_path / "fp.ckpt")
    Solver(
        CDAE(CDAEConfig(num_dim=5, batch_size=32, loss="SQUARE")),
        max_iteration=1, seed=7, verbose=False,
    ).train(train, test, [], checkpoint_path=path)
    other = Solver(
        CDAE(CDAEConfig(num_dim=5, batch_size=32, loss="SQUARE",
                        learn_rate=0.05)),
        max_iteration=2, seed=7, verbose=False,
    )
    with pytest.raises(ValueError, match="fingerprint"):
        other.train(train, test, [], resume_from=path)


def test_sharded_checkpoint_roundtrip(tmp_path, movielens_path):
    """Orbax sharded checkpoint preserves values + shardings on a mesh."""
    import jax
    from cdae_jax.parallel.mesh import make_mesh
    from cdae_jax.parallel.sharded import shard_cdae_state

    rng = np.random.default_rng(0)
    pairs = np.unique(rng.integers(0, 32 * 64, 500))
    train = Interactions.from_arrays(
        (pairs // 64).astype(np.int32), (pairs % 64).astype(np.int32),
        num_users=32, num_items=64,
    )
    model = CDAE(CDAEConfig(num_dim=8, batch_size=32, loss="SQUARE"))
    mesh = make_mesh(n_data=4, n_model=2)
    state = model.reset(train, seed=0)
    state.params = shard_cdae_state(mesh, state.params)
    state.step = 7
    path = str(tmp_path / "sharded_ckpt")
    ckpt.save_sharded(path, state)

    state2 = model.reset(train, seed=99)
    state2.params = shard_cdae_state(mesh, state2.params)
    state2 = ckpt.load_sharded(path, state2)
    assert state2.step == 7
    for k in state.params:
        np.testing.assert_array_equal(
            np.asarray(state.params[k]), np.asarray(state2.params[k])
        )
        assert state2.params[k].sharding == state.params[k].sharding


def test_sharded_checkpoint_exact_resume(tmp_path, movielens_path):
    """Sharded (orbax) checkpoint + sidecar rng manifest gives BITWISE exact
    resume on the mesh: train 2 epochs, save with the stream key, restore
    into a fresh state, train epoch 3 — identical to never having stopped.
    Fingerprint mismatch refuses to resume, like the npz format."""
    import jax
    from cdae_jax.parallel.mesh import make_mesh
    from cdae_jax.parallel.trainer import ShardedCDAE

    rng = np.random.default_rng(1)
    pairs = np.unique(rng.integers(0, 32 * 64, 600))
    train = Interactions.from_arrays(
        (pairs // 64).astype(np.int32), (pairs % 64).astype(np.int32),
        num_users=32, num_items=64,
    )
    mesh = make_mesh(n_data=4, n_model=2)
    cfg = CDAEConfig(num_dim=8, batch_size=16, loss="SQUARE",
                     corruption_ratio=0.2, num_neg=2)

    def fresh():
        m = ShardedCDAE(cfg, mesh=mesh)
        return m, m.reset(train, seed=3)

    model, state = fresh()
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, 3)
    state = model.train_one_iteration(state, keys[0])
    state = model.train_one_iteration(state, keys[1])
    path = str(tmp_path / "resume_ckpt")
    fp = ckpt.config_fingerprint(model, state)
    ckpt.save_sharded(path, state, rng_key=keys[2], fingerprint=fp)
    # unbroken run: one more epoch
    state = model.train_one_iteration(state, keys[2])

    model2, state2 = fresh()
    with pytest.raises(ValueError, match="fingerprint"):
        ckpt.load_sharded(path, state2, expect_fingerprint="deadbeef")
    state2 = ckpt.load_sharded(path, state2, expect_fingerprint=fp)
    assert state2.step == 2
    k_resume = ckpt.sharded_rng_key(path)
    np.testing.assert_array_equal(np.asarray(k_resume), np.asarray(keys[2]))
    state2 = model2.train_one_iteration(state2, k_resume)
    for k in state.params:
        np.testing.assert_array_equal(
            np.asarray(state.params[k]), np.asarray(state2.params[k]),
            err_msg=k,
        )


def test_sweep_paper_grid_matches_reference_script():
    """paper_grid must enumerate ref apps/yelp/cdae.sh:3-25 exactly:
    192 points, loops nested in script order (LOSS innermost)."""
    from cdae_jax.sweep import paper_grid

    grid = list(paper_grid())
    assert len(grid) == 2 * 2 * 6 * 2 * 2 * 2
    assert grid[0] == dict(scaled=False, user_factor=True, cratio=0.0,
                           linear=False, asym=True, loss="SQUARE")
    assert grid[1]["loss"] == "CE"  # LOSS is the innermost loop
    assert grid[2]["asym"] is False  # then ASYM
    # every point unique
    keys = {tuple(sorted(g.items())) for g in grid}
    assert len(keys) == len(grid)


def test_cli_warp_pool_and_build_knobs(tmp_path, movielens_path):
    """--warp_pool / --num_shared_neg / --epoch_chunk reach MFConfig from
    the CLI; warp_pool runs in the CSR (no dense mask) regime."""
    cache = str(tmp_path / "ml.bin")
    main(["--task", "prepare", "--input_file", movielens_path,
          "--cache_file", cache, "--parser", "movielens"])
    rc = main(["--task", "train", "--method", "WARP", "--num_dim", "4",
               "--max_iters", "2", "--eval_iters", "2",
               "--batch_size", "16", "--warp_pool", "16",
               "--dense_mode", "false", "--epoch_chunk", "4",
               "--skip_popularity", "--cache_file", cache])
    assert rc == 0
    rc = main(["--task", "train", "--method", "BPR", "--num_dim", "4",
               "--max_iters", "2", "--eval_iters", "2",
               "--batch_size", "16", "--dense_mode", "true",
               "--num_shared_neg", "8", "--learn_rate", "0.2",
               "--skip_popularity", "--cache_file", cache])
    assert rc == 0
