"""Data-parallel training of the port (``parallel/mesh.py``) against one
process and against the JAX package, on the CPU.

  * ``cluster_spec_from_env`` equals the JAX function's on a table of
    launcher environments; each rank's card (2 nodes of 8 cards among
    them) and its backend (NCCL on a card, gloo on the CPU);
  * the loader's shard ``k`` of 2 equals the JAX ``DetDataLoader(
    num_shards=2, shard_id=k)`` over two epochs;
  * two gloo processes, one image each, compute the step of one process on
    the two-image batch, in float64 (``Float64``) at seeds 0, 1 and 2: the
    tiny flagship (frozen BN) on JAX's ``train_sample`` and sampling from
    one shared generator, the tiny GCNet SyncBN Mask R-CNN (live BN) with
    explicit RPN and RoI uniforms sliced per rank, and a step where one
    rank's image has no gt (no positive anchor there).  At both steps the
    losses within 1e-10, each gradient, parameter and buffer within 1e-9
    of its tensor's largest plus 1e-12 of the network's (a tensor whose
    gradient is 0 but rounding, as a ContextBlock's ``conv_mask.bias``);
  * the 2-rank flagship step in float32 against JAX's global step on the
    same two images at the detectors harness's tolerances;
  * the group's rendezvous times out alone, its barrier outwaits the
    rendezvous's timeout, and the train CLI joins from the launcher's
    variables, trains each rank's shard and evaluates on every rank.

The ranks run in processes spawned once for the module (``torch.
multiprocessing``, a ``file://`` rendezvous under the test's temporary
directory, one thread each) while this process runs the one-process
steps; each join has its own timeout, so a rank that hangs fails the test
instead of holding the suite.  The tests of ``init_distributed`` itself
join at a free local TCP port.  This module imports no JAX at its top:
the spawned ranks import it to find their entry point.
"""
import contextlib
import datetime
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.overrides import TorchFunctionMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.parallel import mesh  # noqa: E402

WORLD = 2
JOIN_TIMEOUT_S = 60
BARRIER_JOIN_S = 2
CANVAS = (128, 160)
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1_")


# -------------------------------------------------------------- the ranks
class Float64(TorchFunctionMode):
    """The port computing in float64: every float32 that it asks for (a
    ``dtype`` argument, ``.float()``, ``type_as`` a float32 tensor, the
    default dtype) becomes float64, with the network's parameters and
    buffers made float64 by the caller.  The rank-against-one-process
    comparison runs under it, where a sum taken in another order differs
    by ~1e-16 of it instead of float32's ~1e-7, so that no seed's
    amplification of that rounding through a random tiny model comes near
    the bound."""

    def __enter__(self):
        self._default = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        return super().__enter__()

    def __exit__(self, *exc):
        torch.set_default_dtype(self._default)
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.float:
            return args[0].double()
        if func is torch.Tensor.type_as and args[1].dtype == torch.float32:
            return args[0].double()

        def wide(a):
            return torch.float64 if a is torch.float32 else a

        return func(*map(wide, args), **{k: wide(v) for k, v in (kwargs or {}).items()})


def _sched():
    return t_train.step_lr_schedule(0.02, 1, decay_epochs=(1,), warmup_iters=2,
                                    warmup_ratio=0.5)


def run_steps(job, rank=0, world=1):
    """Two train steps of ``job`` (a dict: model config, state dict, batch,
    per-step samples or sampler uniforms, a generator seed, ``float64``) on
    its batch's images of ``rank`` of ``world``; returns the losses,
    gradients, parameters and buffers after each step.  A step without a
    given sample samples inside: from the job's uniforms where it gives
    them, else from the generator."""
    torch.manual_seed(0)
    det = build_detector(job["mc"], device="cpu")
    det.net.load_state_dict(job["state"], strict=True)
    anchors, nla = det.anchors_for(CANVAS)
    n = job["batch"]["images"].shape[0] // world
    part = slice(rank * n, (rank + 1) * n)
    batch = {k: v[part] for k, v in job["batch"].items()}
    out = []
    with Float64() if job["float64"] else contextlib.nullcontext():
        if job["float64"]:
            det.net.double()
        step = t_train.make_train_step(det, anchors, nla, t_train.make_optimizer(
            det.net.parameters(), _sched(), aux_params=t_train.aux_parameters(det.net)))
        gen = None if job.get("seed") is None else torch.Generator().manual_seed(job["seed"])
        for k in range(2):
            kw = {key: u[part] for key, u in (job.get("uniforms") or ({}, {}))[k].items()}
            if job.get("samples") is not None:
                kw["sample"] = tuple(np.asarray(x)[part] for x in job["samples"][k])
            metrics = step(batch, generator=gen, **kw)
            out.append(dict(
                metrics={m: float(v) for m, v in metrics.items()},
                grads={name: p.grad.clone() for name, p in det.net.named_parameters()
                       if p.grad is not None},
                params={name: p.detach().clone() for name, p in det.net.named_parameters()},
                buffers={name: b.clone() for name, b in det.net.named_buffers()}))
    return out


def _rank_main(rank, world, rdv, job_files, out_dir):
    """Each file of ``job_files`` in turn (waiting for one that the parent
    has not written yet), its jobs' steps on this rank's images."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        results = {}
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for path in job_files:
            while not os.path.exists(path) and time.monotonic() < deadline:
                time.sleep(0.05)
            jobs = torch.load(path, weights_only=False)
            results.update({name: run_steps(job, rank, world) for name, job in jobs.items()})
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def save_jobs(jobs, path):
    """``jobs`` to ``path``, whole or not at all (a rank may be waiting)."""
    torch.save(jobs, path + ".part")
    os.replace(path + ".part", path)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank, world, port):
    return {"COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NUM_PROCESSES": str(world),
            "PROCESS_ID": str(rank)}


def _cli_rank_main(rank, world, rdv, job, out_dir):
    """A rank of the train CLI, which joins the group itself from the
    launcher's variables (``COORDINATOR_ADDRESS`` on a free local port)."""
    from boosting_rcnn_tpu_torch.tools import train as train_cli

    torch.set_num_threads(1)
    argv, port = job
    os.environ.update(_env(rank, world, port))
    try:
        summary = train_cli.main(argv + ["--work-dir", os.path.join(out_dir, f"wd{rank}")])
        torch.save({"backend": dist.get_backend(), **{k: summary[k] for k in (
            "steps", "images", "last_metrics", "checkpoints", "eval")}},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _barrier_rank_main(rank, world, rdv, port, out_dir):
    """Rank 0 keeps the other waiting at the barrier for longer than the
    join's timeout, as a checkpoint or an evaluation may (the ranks start
    the join together: each waits for the other's file first)."""
    open(f"{rdv}.{rank}", "w").close()
    while not all(os.path.exists(f"{rdv}.{r}") for r in range(world)):
        time.sleep(0.01)
    mesh.JOIN_TIMEOUT = datetime.timedelta(seconds=BARRIER_JOIN_S)
    assert mesh.init_distributed("cpu", env=_env(rank, world, port))
    try:
        if rank == 0:
            time.sleep(BARRIER_JOIN_S + 1)
        t0 = time.monotonic()
        mesh.barrier()
        torch.save({"backend": dist.get_backend(), "waited": time.monotonic() - t0},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_ranks(jobs, tmp_dir, world=WORLD, nprocs=None, main=None, later=0):
    """Start ``world`` spawned ranks (``nprocs`` of them, all by default):
    ``_rank_main`` over ``jobs`` (saved to a file) and then over ``later``
    more job files (``jobs<k>.pt`` under ``tmp_dir``, k = 1, 2, ...,
    written by the caller with ``save_jobs``), or ``main(rank, world, rdv,
    jobs, tmp_dir)`` where given."""
    if main is None:
        main, payload = _rank_main, [os.path.join(tmp_dir, f"jobs{k}.pt")
                                     for k in range(later + 1)]
        save_jobs(jobs, payload[0])
    else:
        payload = jobs
    return mp.start_processes(main, args=(world, os.path.join(tmp_dir, "rdv"), payload, tmp_dir),
                              nprocs=nprocs or world, join=False, start_method="spawn")


def join_ranks(ctx, tmp_dir, world=WORLD, timeout=JOIN_TIMEOUT_S):
    """Each rank's results.  Fails (and kills the ranks) where they do not
    all end within ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world} ranks did not end within {timeout} s")
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def spawn_ranks(jobs, tmp_dir, world=WORLD, timeout=JOIN_TIMEOUT_S, nprocs=None, main=None):
    return join_ranks(start_ranks(jobs, tmp_dir, world, nprocs, main), tmp_dir, world, timeout)


# ------------------------------------------------------------- the jobs
def _flagship():
    """The tiny flagship's config (``tests/test_torch_train.py``'s shrink),
    its JAX detector and the shapes of its JAX variables."""
    import jax
    from boosting_rcnn_tpu.builder import build_detector as jax_build
    from boosting_rcnn_tpu.config import load_config as jax_load_config
    from boosting_rcnn_tpu_torch.config import load_config
    from test_torch_boosting_detectors import config_path
    from test_torch_train import _tiny

    path = config_path("boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")
    jdet = jax_build(_tiny(jax_load_config(path).model.to_dict()))
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    return _tiny(load_config(path).model.to_dict()), jdet, shapes


def _random_state(det, rs):
    """The state dict of ``det``'s network drawn from ``rs`` as the
    detectors harness draws JAX variables: kernels LeCun-scaled, norm
    scales around 1, running variances in [0.5, 1.5], the RPN's class
    biases around -2, the rest around 0."""
    out = {}
    for name, v in det.net.state_dict().items():
        shape = tuple(v.shape)
        if not v.is_floating_point():
            x = v
        elif name.endswith("running_var"):
            x = rs.uniform(0.5, 1.5, shape)
        elif name.endswith("weight") and v.dim() > 1:
            x = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith("weight"):
            x = 1.0 + 0.1 * rs.randn(*shape)
        elif "rpn_cls" in name:
            x = -2.0 + 0.1 * rs.randn(*shape)
        else:
            x = 0.1 * rs.randn(*shape)
        out[name] = torch.as_tensor(np.asarray(x, np.float32)) if v.is_floating_point() else x
    return out


def _flagship_jax(flagship, variables, batch):
    """JAX's samples for two steps and JAX's global step (the JAX package's
    ``external`` step on the whole batch) of the tiny flagship."""
    import jax
    import jax.numpy as jnp
    import optax
    from boosting_rcnn_tpu.engine import train as j_train
    from boosting_rcnn_tpu_torch.weights import from_jax_params

    jdet = flagship[1]
    jv, jb = jax.tree.map(jnp.asarray, variables), jax.tree.map(jnp.asarray, batch)
    anchors, nla = jdet.anchors_for(CANVAS)
    rng = jax.random.PRNGKey(3)
    sample_fn = jax.jit(lambda v, r: jdet.train_sample(v, r, jb, anchors, nla))

    def j_loss(params, stats, sample, key):
        losses, new_stats = j_train.loss_with_live_bn(
            jdet, {"params": params, "batch_stats": stats}, key, jb, anchors, nla, sample=sample)
        return sum(losses.values()), (losses, new_stats)

    grad_fn = jax.jit(jax.value_and_grad(j_loss, has_aux=True))
    tx = j_train.make_optimizer(j_train.step_lr_schedule(
        0.02, 1, decay_epochs=(1,), warmup_iters=2, warmup_ratio=0.5),
        params=jv["params"], frozen_stages=1)
    state = j_train.create_train_state(jv, tx)
    apply_fn = jax.jit(lambda st, g: (st.apply_gradients(g), optax.global_norm(g)))
    samples, steps = [], []
    for k in range(2):
        sample = sample_fn({"params": state.params, "batch_stats": state.batch_stats}, rng)
        (total, (losses, _)), grads = grad_fn(state.params, state.batch_stats, sample,
                                              jax.random.fold_in(rng, state.step))
        state, grad_norm = apply_fn(state, grads)
        samples.append(tuple(np.array(x) for x in sample))
        steps.append(dict(metrics={"loss": float(total), "grad_norm": float(grad_norm),
                                   **{n: float(v) for n, v in losses.items()}},
                          params=from_jax_params(jax.tree.map(np.asarray, state.params))))
    return samples, steps


def _uniforms(rs, batch, det, rpn=True):
    """Explicit sampler uniforms for the whole batch at each of two steps:
    the RoI sampler's ``(B, 2, G + P)`` and the plain RPN's ``(B, 2, A)``
    of ``det``."""
    anchors, _ = det.anchors_for(CANVAS)
    b, g = batch["gt_bboxes"].shape[:2]
    p = det.train_proposal_cfg.max_per_img
    steps = []
    for _ in range(2):
        u = {"roi_uniforms": rs.rand(b, 2, g + p).astype(np.float32)}
        if rpn:
            u["rpn_uniforms"] = rs.rand(b, 2, anchors.shape[0]).astype(np.float32)
        steps.append(u)
    return steps


# The seeds of the weights and batches of the rank checks: each job at
# every one of them, none chosen.
SEEDS = (0, 1, 2)


def make_jobs():
    """The float64 jobs of the rank checks that need no JAX (``name`` at
    seed 0, ``name-<seed>`` at the others): the tiny flagship and the tiny
    GCNet SyncBN Mask R-CNN (as ``tests/test_torch_norm_configs.py`` shrinks
    it, with live BN) on the port's own weights, drawn as the harness
    draws."""
    from boosting_rcnn_tpu_torch.config import load_config
    from test_torch_boosting_detectors import _batch, config_path
    from test_torch_norm_configs import GCNET, tiny_norms
    from test_torch_norm_configs import _batch as norm_batch
    from test_torch_train import CONFIG, _tiny

    flag_mc = _tiny(load_config(CONFIG).model.to_dict())
    gc_mc = tiny_norms(load_config(config_path(GCNET)).model.to_dict())
    flag_det, gc_det = (build_detector(mc, device="cpu") for mc in (flag_mc, gc_mc))
    jobs = {}
    for seed in SEEDS:
        tag = "" if seed == 0 else f"-{seed}"
        rs = np.random.RandomState(seed)
        flagship = dict(mc=flag_mc, state=_random_state(flag_det, rs),
                        batch=_batch(rs, 4, CANVAS), float64=True)
        jobs["flagship_generator" + tag] = dict(flagship, seed=5 + seed)
        if seed == 0:
            no_pos = dict(flagship, batch=dict(flagship["batch"]))
            for key in ("gt_mask", "gt_bboxes", "gt_labels"):  # image 1: no gt
                no_pos["batch"][key] = no_pos["batch"][key].copy()
                no_pos["batch"][key][1] = 0
            no_pos["uniforms"] = _uniforms(rs, no_pos["batch"], flag_det, rpn=False)
            jobs["no_positive"] = no_pos
        batch = norm_batch(rs, True, 2)
        jobs["gcnet" + tag] = dict(mc=gc_mc, state=_random_state(gc_det, rs), batch=batch,
                                   uniforms=_uniforms(rs, batch, gc_det), float64=True)
    return jobs


def make_jax_jobs():
    """The tiny flagship on the harness's JAX variables and batch (seed 0)
    with JAX's samples, in float64 and in float32, and JAX's global step
    of it."""
    from boosting_rcnn_tpu_torch.weights import from_jax_params
    from test_torch_boosting_detectors import _batch, _random_variables

    flagship_model = _flagship()
    rs = np.random.RandomState(0)
    variables = _random_variables(flagship_model[2], rs)
    batch = _batch(rs, 4, CANVAS)
    samples, jax_steps = _flagship_jax(flagship_model, variables, batch)
    job = dict(mc=flagship_model[0], state=from_jax_params(variables), batch=batch,
               samples=samples, float64=True)
    return {"flagship_jax": job, "flagship_jax_f32": dict(job, float64=False)}, jax_steps


@pytest.fixture(scope="module")
def parallel_runs(tmp_path_factory):
    """Each job's two steps in 2 ranks and in one process; JAX's global
    step of the flagship job.  The ranks start on the jobs without JAX
    while this process builds JAX's, then take those; this process runs
    the one-process steps meanwhile."""
    jobs = make_jobs()
    tmp = str(tmp_path_factory.mktemp("ranks"))
    ranks = start_ranks(jobs, tmp, later=1)
    threads = torch.get_num_threads()
    try:
        jax_jobs, jax_steps = make_jax_jobs()
        save_jobs(jax_jobs, os.path.join(tmp, "jobs1.pt"))
        jobs.update(jax_jobs)
        torch.set_num_threads(1)
        single = {name: run_steps(job) for name, job in jobs.items() if job["float64"]}
    except BaseException:
        for p in ranks.processes:
            p.kill()
        raise
    finally:
        torch.set_num_threads(threads)
    return dict(jobs=jobs, ranks=join_ranks(ranks, tmp), single=single, jax=jax_steps)


RANK_JOBS = ["flagship_jax", "flagship_generator", "gcnet", "no_positive"] + [
    f"{name}-{seed}" for seed in SEEDS[1:] for name in ("flagship_generator", "gcnet")]


@pytest.mark.parametrize("job", RANK_JOBS)
def test_two_ranks_compute_the_one_process_step(parallel_runs, job):
    """In float64, at both steps: the losses within 1e-10 (relative), each
    gradient, parameter and buffer within 1e-9 of its tensor's largest
    magnitude (plus 1e-12 of the network's)."""
    single = parallel_runs["single"][job]
    p0 = parallel_runs["jobs"][job]["state"]
    for r, rank in enumerate(parallel_runs["ranks"]):
        for k, (got, ref) in enumerate(zip(rank[job], single)):
            assert set(got["metrics"]) == set(ref["metrics"])
            for m, v in ref["metrics"].items():
                np.testing.assert_allclose(got["metrics"][m], v, rtol=1e-10,
                                           err_msg=f"rank {r} step {k} {m}")
            assert set(got["grads"]) == set(ref["grads"])
            for group in ("grads", "params", "buffers"):
                values = ref[group]
                net = max(v.abs().max().item() for v in values.values()
                          if v.is_floating_point() and v.numel())
                for name, v in values.items():
                    g = got[group][name]
                    if not v.is_floating_point():
                        assert torch.equal(g, v), name
                        continue
                    assert g.dtype == torch.float64, name
                    np.testing.assert_allclose(
                        g.numpy(), v.numpy(), rtol=0,
                        atol=1e-9 * v.abs().max().item() + 1e-12 * net,
                        err_msg=f"rank {r} step {k} {group} {name}")
            for name, v in ref["params"].items():
                if not name.startswith(FROZEN):
                    continue
                assert torch.equal(v, p0[name].double()), name  # the frozen stages stay
    moved = [n for n, b in single[-1]["buffers"].items() if n.endswith("running_mean")
             and not torch.equal(b, p0[n].double())]
    assert bool(moved) == job.startswith("gcnet")  # the live BN's statistics moved, globally


def test_two_ranks_match_jax_global_step(parallel_runs):
    """The 2-rank flagship step in float32 against the JAX package's step
    on the whole batch, at the detectors harness's tolerances (seed 0, the
    harness's)."""
    p0 = parallel_runs["jobs"]["flagship_jax_f32"]["state"]
    for k, ref in enumerate(parallel_runs["jax"]):
        got = parallel_runs["ranks"][0]["flagship_jax_f32"][k]
        other = parallel_runs["ranks"][1]["flagship_jax_f32"][k]["params"]
        assert all(torch.equal(v, other[n]) for n, v in got["params"].items())
        for m, v in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][m], v, rtol=1e-4, err_msg=m)
        moved = 0
        for name, p in ref["params"].items():
            g, start = got["params"][name], p0[name]
            p = p.reshape(g.shape)
            delta = (p - start).abs().max().item()
            moved += delta > 0
            np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0,
                                       atol=1e-3 * delta + 1e-7 * p.abs().max().item(),
                                       err_msg=name)
        assert moved >= 50


def test_no_positive_rank_keeps_the_global_normalisers(parallel_runs):
    """Rank 1's image has no gt: its RPN and R-CNN positives are none, and
    its losses still divide by the global counts (as the one process on
    both images)."""
    job = parallel_runs["jobs"]["no_positive"]
    assert not job["batch"]["gt_mask"][1].any() and job["batch"]["gt_mask"][0].any()
    got = parallel_runs["ranks"][1]["no_positive"][0]["metrics"]
    ref = parallel_runs["single"]["no_positive"][0]["metrics"]
    assert ref["loss_rpn_bbox"] > 0 and np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss_rpn_bbox"], ref["loss_rpn_bbox"], rtol=1e-10)


def test_a_hung_rank_fails_within_its_timeout(tmp_path):
    """A rank that never joins the group: the join's own timeout ends the
    test instead of the suite's."""
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="did not end"):
        spawn_ranks({}, str(tmp_path), world=2, timeout=3, nprocs=1)  # rank 1 never comes
    assert time.monotonic() - t0 < 30


def test_init_distributed_join_times_out_alone(monkeypatch):
    """Process 0 of 2 joins and process 1 never comes: the rendezvous
    raises after its join timeout."""
    monkeypatch.setattr(mesh, "JOIN_TIMEOUT", datetime.timedelta(seconds=BARRIER_JOIN_S))
    t0 = time.monotonic()
    try:
        with pytest.raises(Exception, match="(?i)time"):
            mesh.init_distributed("cpu", env=_env(0, 2, _free_port()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert BARRIER_JOIN_S - 1 < time.monotonic() - t0 < 30


def test_a_rank_waits_at_the_barrier_past_the_join_timeout(tmp_path):
    """The group's collectives wait longer than its rendezvous: rank 1
    waits at the barrier while rank 0 works past the join timeout."""
    ranks = spawn_ranks(_free_port(), str(tmp_path), main=_barrier_rank_main)
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    assert ranks[1]["waited"] > BARRIER_JOIN_S


def test_train_cli_trains_on_each_ranks_shard(tmp_path):
    """The train CLI in 2 ranks that join from the launcher's variables, on
    a generated COCO set of 8 images at 2 an image a rank: each rank steps
    through its shard of the epoch (2 steps of 2 images), logs the ranks'
    averaged losses (equal on both) and evaluates the val split (the same
    metrics on both, as every JAX process evaluates), and rank 0 alone
    writes the checkpoint."""
    from boosting_rcnn_tpu_torch.data.synthetic import generate

    root = str(tmp_path / "set")
    generate(root, n_train=8, n_val=2, seed=6, frame_sizes=[(80, 64)], object_scale=0.5)
    argv = [os.path.join(REPO, "configs/suodac/faster_rcnn_r50_fpn_1x.py"), "--device", "cpu",
            "--tiny", "--iters", "2", "--cfg-options",
            f"data.train.ann_file={root}/train.json", f"data.train.img_prefix={root}/train",
            f"data.val.ann_file={root}/val.json", f"data.val.img_prefix={root}/val",
            "data.train.domain_file=None", "data.samples_per_gpu=2", "runner.max_epochs=1",
            "model.backbone.init_cfg=None"]
    ranks = spawn_ranks((argv, _free_port()), str(tmp_path), main=_cli_rank_main)
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    assert [r["steps"] for r in ranks] == [2, 2] and [r["images"] for r in ranks] == [4, 4]
    assert ranks[0]["last_metrics"]["loss"] == ranks[1]["last_metrics"]["loss"]
    assert len(ranks[0]["eval"]) == len(ranks[1]["eval"]) == 1
    strip = [{k: v for k, v in r["eval"][0].items() if k not in ("seconds", "images_per_s")}
             for r in ranks]
    np.testing.assert_equal(strip[0], strip[1])
    assert "bbox_mAP" in strip[0]
    assert len(ranks[0]["checkpoints"]) == 1 and ranks[1]["checkpoints"] == []
    assert not os.path.exists(tmp_path / "wd1" / "epoch_1")


# ------------------------------------------------------- launcher and shards
ENVS = [
    {"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4", "PROCESS_ID": "2"},
    {"COORDINATOR_ADDRESS": "host:9"},
    {"SLURM_STEP_NODELIST": "gpu[007-009,012]", "SLURM_NTASKS": "8", "SLURM_PROCID": "3",
     "SLURM_JOB_ID": "4242"},
    {"SLURM_JOB_NODELIST": "a1,b2", "SLURM_NTASKS": "2", "SLURM_PROCID": "1",
     "COORDINATOR_PORT": "5555"},
    {"SLURM_JOB_NODELIST": "n-[1-2]", "SLURM_STEP_NODELIST": "m[3,5]", "SLURM_NTASKS": "2"},
    {"SLURM_JOB_NODELIST": "solo", "SLURM_NTASKS": "1"},
    {"SLURM_PROCID": "0"},
    {},
    {"SLURM_JOB_NODELIST": "gpu[01-02]", "SLURM_NTASKS": "16", "SLURM_PROCID": "11",
     "SLURM_LOCALID": "3", "SLURM_JOB_ID": "77"},  # 2 nodes of 8 cards
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_cluster_spec_matches_jax(env):
    from boosting_rcnn_tpu.parallel.mesh import cluster_spec_from_env as j_spec

    assert mesh.cluster_spec_from_env(env) == j_spec(env)


CARDS = [  # (env, the host's cards, the rank's card)
    (ENVS[-1], 8, 3),
    ({"COORDINATOR_ADDRESS": "gpu01:8476", "NUM_PROCESSES": "16", "PROCESS_ID": "11"}, 8, 3),
    ({"COORDINATOR_ADDRESS": "gpu01:8476", "NUM_PROCESSES": "16", "PROCESS_ID": "11",
      "LOCAL_RANK": "5"}, 8, 5),
    ({}, 1, 0),
]


@pytest.mark.parametrize("env,cards,card", CARDS, ids=range(len(CARDS)))
def test_a_rank_trains_on_its_card_over_nccl(env, cards, card, monkeypatch):
    """Each rank's card on a host of ``cards`` (2 nodes of 8: the local
    id, not the global rank), NCCL for a rank on a card and gloo for one
    on the CPU, whatever the world's size."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    device = mesh.local_device(env)
    assert device == torch.device("cuda", card)
    assert mesh.backend_for(device) == "nccl" and mesh.backend_for("cpu") == "gloo"


def test_single_process_is_the_identity():
    assert not mesh.init_distributed("cpu", env={})
    x = torch.tensor([3.0, 0.0])
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_main()
    assert mesh.all_reduce_mean(x) is x and mesh.differentiable_mean(x) is x
    assert torch.equal(mesh.global_count(torch.tensor(0.0)), torch.tensor(1.0))


@pytest.mark.parametrize("shard", [0, 1])
def test_loader_shard_matches_jax(tmp_path, shard):
    from boosting_rcnn_tpu.data.coco import CocoDataset as JCoco
    from boosting_rcnn_tpu.data.loader import DetDataLoader as JLoader
    from boosting_rcnn_tpu_torch.data.coco import CocoDataset as TCoco
    from boosting_rcnn_tpu_torch.data.loader import DetDataLoader as TLoader
    from boosting_rcnn_tpu_torch.data.synthetic import generate

    root = str(tmp_path)
    generate(root, n_train=9, n_val=0, seed=3, frame_sizes=[(80, 64)], n_portrait=3,
             object_scale=0.5)
    ann, img = os.path.join(root, "train.json"), os.path.join(root, "train")
    kw = dict(batch_size=2, canvas=(64, 80), train=True, seed=1, num_shards=2,
              shard_id=shard, mstrain_range=(48, 64))
    tl, jl = TLoader(TCoco(ann, img), scale=(80, 64), **kw), JLoader(JCoco(ann, img), **kw)
    assert len(tl) == len(jl) > 0
    for epoch in range(2):
        tb, jb = list(tl.epoch_iter(epoch)), list(jl.epoch_iter(epoch))
        assert len(tb) == len(jb) == len(tl)
        for t, j in zip(tb, jb):
            np.testing.assert_allclose(t["images"].numpy(), j["images"], rtol=0, atol=1e-4)
            for key in set(j) - {"images"}:
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
