"""The sharded port on several ranks: gloo process groups on the CPU.

One 4-rank world (spawned once for the module, ``file://`` store under
``tmp_path``, one thread a rank) runs ``repro_torch.launch.check_dist``'s
checks, which a 4-card machine runs under ``torchrun`` with NCCL; rank 0
writes the readings to JSON and the tests below assert on them:

* the sharded TL step on the (2, 2) debug mesh against the port's
  one-device step, for deepseek-7b, deepseek-v3-671b (MoE + MLA + MTP),
  mamba2-780m and recurrentgemma-9b at reduced size, B=4, S=16, reassembly
  "torch" and "kernel" (the kernel's plain version on the CPU): loss 1e-4,
  params 5e-3, the reference's gates (``tests/test_sharding_multidevice.py``);
  the same on a (2, 2, 1) (pod, data, model) mesh and with
  ``microbatch=2``;
* ``pipeline=True`` == ``False`` and ``donate=True`` == ``False`` on the
  mesh, bit-equal; checkpoints written sharded load one-device and the
  other way round, bit-equal;
* ``moe_apply_ep`` against ``moe_apply`` on reduced deepseek-v2, (4, 8, d):
  rel < 2e-3 (``tests/test_moe_ep.py``), finite grads, a nonzero ``w_gate``
  grad, expert grads equal to ``moe_apply`` 's;
* ``constrain_batch`` and the DTensor row permuter; ``resolve_mesh``.

The CLI drills run as the reference's do (``tests/test_elastic.py``): the
elastic kill drill under ``torchrun`` on 4 ranks, the unsupervised hang as
one rank.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.launch.check_dist import ARCHS  # noqa: E402

REASSEMBLY = ["torch", "kernel"]

WORLD = textwrap.dedent('''
    import json, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def work(rank, world, store, ckdir, out_path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from repro_torch.launch.check_dist import run_checks
        out = run_checks("cpu", ckdir)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(work, args=(4, sys.argv[1], sys.argv[2], sys.argv[3]),
                 nprocs=4)
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    script = tmp / "world.py"
    script.write_text(WORLD)
    out = tmp / "out.json"
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp / "store"), str(tmp / "ck"),
         str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("reassembly", REASSEMBLY)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_device(world, arch, reassembly):
    got = world[f"step/{arch}/{reassembly}"]
    assert got["loss"] < 1e-4, got
    assert got["params"] < 5e-3, got


@pytest.mark.parametrize("case", ["multipod", "microbatch"])
def test_sharded_step_multipod_and_microbatch(world, case):
    got = world[f"step/{case}"]
    assert got["loss"] < 1e-4, got
    assert got["params"] < 5e-3, got


@pytest.mark.parametrize("what", ["pipeline", "donate"])
def test_sharded_step_modes_bit_equal(world, what):
    assert world[what] == {"losses": True, "params": True}


@pytest.mark.parametrize("way", ["sharded_to_one", "one_to_sharded"])
def test_checkpoints_cross_between_sharded_and_one_device(world, way):
    assert world["ckpt"][way] is True


def test_expert_parallel_moe_matches_moe_apply(world):
    ep = world["ep"]
    assert ep["rel"] < 2e-3, ep
    assert ep["finite"] and ep["w_gate_grad"] > 0, ep
    assert ep["expert_grad_rel"] < 1e-5, ep
    assert ep["hooked"], ep


def test_constrain_batch(world):
    c = world["constrain"]
    assert c["identity"] and c["plain_identity"], c
    assert c["placements"] == ["S(0)", "R"] and c["values"], c


def test_row_permuter_on_dtensors_is_shard_local(world):
    # perm [1, 0 | 0, 1] over two data shards of rows [0, 4 | 8, 12]: each
    # shard permutes its own rows
    p = world["permuter"]
    assert p["placements"] == ["S(0)", "R"], p
    assert p["rows"] == [4.0, 0.0, 8.0, 12.0], p
    assert p["kernel_refuses"], p     # K1 reads data_ptr(): local tensors


def test_resolve_mesh_on_four_ranks(world):
    assert world["debug_shape"] == [2, 2]
    assert world["host_shape"] == [2, 2]
    assert "256" in world["production"] and "4" in world["production"]


# ------------------------------------------------------------- CLI drills

def _env():
    return dict(os.environ, PYTHONPATH=os.path.abspath("src"),
                OMP_NUM_THREADS="1")


CLI = ["-m", "repro_torch.launch.train", "--device", "cpu", "--mesh",
       "debug", "--nodes", "2", "--batch", "4", "--seq", "32",
       "--log-every", "0"]


def test_recovery_drill_elastic_is_bit_equal(tmp_path):
    """Kill at step 3 with --ckpt-every 2 on a 4-rank (2, 2) mesh: rollback
    to step 2, the (1, 2) mesh over the survivors, and the run's final
    params bit-equal to a fresh run from that checkpoint on that mesh."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4"] + CLI[:1] + CLI[1:] +
        ["--steps", "4", "--elastic", "--drill", "kill-device:3",
         "--ckpt", str(tmp_path), "--ckpt-every", "2", "--ckpt-keep", "2"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    drill = [ln for ln in lines if ln.startswith("RECOVERY_DRILL")]
    assert len(drill) == 1, proc.stdout
    assert "bit_equal=true" in drill[0] and "rollback_step=2" in drill[0]
    assert "mesh=(1, 2)" in drill[0]
    rec = [ln for ln in lines if ln.startswith("recovery:")]
    assert len(rec) == 1 and "'rollback_depth': 1" in rec[0]


def test_drill_without_elastic_fails_loudly_via_watchdog():
    proc = subprocess.run(
        [sys.executable] + CLI + ["--steps", "3", "--drill", "hang-device:1",
                                  "--watchdog-s", "3"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr[-3000:]
    assert "FATAL" in proc.stderr
    assert "lost at step 1 (hang)" in proc.stderr
    assert "--elastic" in proc.stderr


@pytest.mark.slow
def test_recovery_drill_hang_elastic(tmp_path):
    """The hang flavour end to end under torchrun: watchdog detection into
    the same reshrink / rollback path, bit-equal verdict included."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4"] + CLI +
        ["--steps", "4", "--elastic", "--drill", "hang-device:2:1",
         "--watchdog-s", "5", "--ckpt", str(tmp_path), "--ckpt-every", "2"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    drill = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RECOVERY_DRILL")]
    assert len(drill) == 1 and "bit_equal=true" in drill[0]
