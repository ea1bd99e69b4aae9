"""PyTorch port vs the JAX package: the data mesh.

Twins of tests/test_parallel.py. The port's mesh is one process looping
over n copies of the CPU (``make_mesh(n, device="cpu")``); the JAX package
runs on its 8 virtual CPU devices (tests/conftest.py). JAX's toy models
(``__graft_entry__``) go into the port through ``from_jax_params``, so
both sides hold the same weights. Both sides run at
``matmul_dtype="f32"``: the JAX tests' default bf16 operands round inside
XLA's jitted CPU programs differently from op-by-op rounding
(tests/test_torch_models.py). Tolerances are the JAX tests':

- sharded cascade: boxes and confidences within 1e-4, masks exact
  (test_parallel.py:52-56);
- GSFA step: mean within rtol 1e-4 / atol 1e-5, W up to sign within
  rtol 1e-2 / atol 1e-3 (test_parallel.py:68-77);
- mesh trainer: moments within atol 1e-5 / rtol 1e-4, canonical
  correlations of the first five features with mean above 0.98 and
  minimum above 0.9 (test_parallel.py:125-151);
- detector under the mesh: boxes and confidences within 1e-4
  (test_parallel.py:178-180), against JAX on the shipped artifacts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_draws import fair_torch_threads  # noqa: F401  (autouse)

import __graft_entry__
from pyfaceanalysis_torch.config import DetectorConfig as TConfig
from pyfaceanalysis_torch.config import NetGeometry as TGeometry
from pyfaceanalysis_torch.engine import cascade as t_cascade
from pyfaceanalysis_torch.engine import detector as t_detector
from pyfaceanalysis_torch.io import artifacts as t_art
from pyfaceanalysis_torch.io import pipeline as t_pipe
from pyfaceanalysis_torch.models import builder as t_builder
from pyfaceanalysis_torch.models import moments as t_moments
from pyfaceanalysis_torch.parallel import dryrun as t_dryrun
from pyfaceanalysis_torch.parallel import mesh as t_mesh
from pyfaceanalysis_torch.parallel import train_step as t_step
from pyfaceanalysis_torch.training import trainer as t_trainer
from pyfaceanalysis_tpu.config import DetectorConfig as JConfig
from pyfaceanalysis_tpu.engine import cascade as j_cascade
from pyfaceanalysis_tpu.engine import detector as j_detector
from pyfaceanalysis_tpu.models import builder as j_builder
from pyfaceanalysis_tpu.models import moments as j_moments
from pyfaceanalysis_tpu.parallel import mesh as j_mesh
from pyfaceanalysis_tpu.parallel import train_step as j_step
from pyfaceanalysis_tpu.training import trainer as j_trainer

N_DEV = 8
TOL = dict(rtol=1e-4, atol=1e-4)            # test_parallel.py:52-56
MOMENT_TOL = dict(atol=1e-5, rtol=1e-4)     # test_parallel.py:125-126


def _port_net(specs, params, input_hw):
    return t_art.from_jax_params([dict(
        field_indices=s.indices_array(), expansion=s.expansion.name,
        exponent=s.expansion.exponent, out_dim=s.out_dim, node=s.node,
        slow_dim=s.slow_dim, clip=s.clip, mean=np.asarray(p.mean),
        W=np.asarray(p.W)) for s, p in zip(specs, params)],
        input_hw=input_hw)


def _port_clf(c):
    return t_art.from_jax_params(gaussian={
        k: np.asarray(getattr(c, k))
        for k in ("means", "inv_covs", "log_norm", "avg_labels")})


def _port_geom(g):
    return TGeometry(**dataclasses.asdict(g))


@pytest.fixture(scope="module")
def toy():
    """JAX's ``_toy_model`` and its port: 16x16 patches, 6 stages."""
    geom, plan, specs, params, clfs = __graft_entry__._toy_model()
    hw = (geom.subimage_height, geom.subimage_width)
    port = (_port_geom(geom), tuple(t_cascade.StagePlan(*p) for p in plan),
            tuple(_port_net(s, p, hw) for s, p in zip(specs, params)),
            tuple(_port_clf(c) for c in clfs))
    return (geom, plan, specs, params, clfs), port


@pytest.fixture(scope="module")
def production():
    """JAX's ``_toy_production_model`` (32x32 patches, the 22-stage layout)
    and the same weights as a port ``DetectionModel`` on the CPU."""
    jm = __graft_entry__._toy_production_model()
    js = jm.spec
    spec = t_pipe.PipelineSpec(
        _port_geom(js.face_geom), _port_geom(js.eye_geom),
        _port_geom(js.age_geom),
        tuple(t_pipe.StageSpec(s.raw_type, s.network_name,
                               s.classifier_name) for s in js.stages))
    nets = {name: _port_net(n.specs, n.params, n.input_hw)
            for name, n in jm.nets.items()}
    tm = t_detector.DetectionModel(spec, nets,
                                   [_port_clf(c) for c in jm.classifiers])
    return jm, tm


def _assert_state(out, ref):
    np.testing.assert_array_equal(np.asarray(out.mask), np.asarray(ref.mask))
    for name in ("boxes", "angles", "conf"):
        np.testing.assert_allclose(np.asarray(getattr(out, name)),
                                   np.asarray(getattr(ref, name)), **TOL,
                                   err_msg=name)


def test_mesh_devices_and_splits():
    mesh = t_mesh.make_mesh(N_DEV, ("data", "model"), shape=(4, 2),
                            device="cpu")
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    assert mesh.size == N_DEV and mesh.leader == torch.device("cpu")
    x = torch.arange(10.0)
    blocks = t_mesh.shard_batch(mesh, {"x": x, "none": None})
    assert [b["x"].tolist() for b in blocks] == [[0, 1, 2], [3, 4, 5],
                                                  [6, 7], [8, 9]]
    assert all(b["none"] is None for b in blocks)
    # No copy where the device already holds the tensor or the module.
    net = t_builder.build_higsfa(16, base_field=4, d=6, top_dim=8)
    reps = t_mesh.replicate(mesh, (x, net))
    assert len(reps) == N_DEV
    assert all(r[0] is x and r[1] is net for r in reps)
    # Fewer cards than asked for raise, naming both counts (the JAX
    # function would build a smaller mesh).
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"asked for {count + 1} CUDA "
                                           f"devices and found {count}"):
        t_mesh.make_mesh(count + 1, device="cuda")


def test_sharded_cascade_matches_jax(toy):
    """test_parallel.py:31-56 with compaction off: the port's sharded
    cascade on 8 CPU copies against JAX's on 8 virtual devices, and against
    the port's own unsharded run."""
    (geom, plan, specs, params, clfs), (tgeom, tplan, nets, tclfs) = toy
    kw = dict(bucket_sizes=(32 * N_DEV,), mid_compact=0, matmul_dtype="f32")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jstate, n_real, _ = j_cascade.make_grid_state(96, 96, geom, jcfg)
    tstate, _, _ = t_cascade.make_grid_state(96, 96, tgeom, tcfg)
    image = np.random.RandomState(0).rand(96, 96).astype(np.float32)
    hw = (geom.subimage_height, geom.subimage_width)
    jout = j_mesh.sharded_cascade(j_mesh.make_mesh(N_DEV, ("data",)), plan,
                                  specs, geom, jcfg, hw, jnp.asarray(image),
                                  params, clfs, jstate)
    assert jout.boxes.sharding.num_devices == N_DEV
    mesh = t_mesh.make_mesh(N_DEV, device="cpu")
    tout = t_mesh.sharded_cascade(mesh, tplan, nets, tgeom, tcfg, hw,
                                  torch.from_numpy(image), tclfs, tstate)
    assert tout.mask.shape[0] == 256 and int(tout.mask.sum()) > 0
    _assert_state(tout, jout)
    _assert_state(tout, t_cascade.run_cascade(
        tplan, nets, tgeom, tcfg, hw, torch.from_numpy(image), tclfs,
        tstate))


def _production_inputs(production, n_images):
    """The production toy's plan on a 96x112 grid (one image, or a fused
    batch of ``n_images``) with both compaction rungs below the real rows
    per image: (JAX config, port config, port run_cascade arguments,
    fused keywords, images)."""
    jm, tm = production
    kw = dict(smallest_face=0.4, bucket_sizes=(1024,), mid_compact=24,
              mid_compact2=12, cut_offs_face=(1.01,) * 10,
              matmul_dtype="f32")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    geom = tm.spec.face_geom
    imgs = np.random.RandomState(3).rand(n_images, 96, 112).astype(
        np.float32)
    if n_images == 1:
        ts, n_real, _ = t_cascade.make_grid_state(112, 96, geom, tcfg)
        timg = torch.from_numpy(imgs[0])
    else:
        ts, n_real, _ = t_cascade.make_batched_grid_state(112, 96, geom,
                                                          tcfg, n_images)
        timg = torch.from_numpy(imgs)
    assert n_real > kw["mid_compact"] > kw["mid_compact2"]
    args = (tm.plan, tm.det_nets, geom, tcfg,
            (geom.subimage_height, geom.subimage_width), timg, tm.det_clfs,
            ts)
    return jcfg, tcfg, args, dict(n_images=n_images, n_per_image=n_real), imgs


# Row selections and copies: exact between sharded and unsharded runs.
SELECTED_FIELDS = ("mask", "orig_cx", "orig_cy", "max_dx", "max_dy",
                   "base_side")


def _assert_same_rows(out, ref, rows=slice(None)):
    for name in SELECTED_FIELDS:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      getattr(ref, name).numpy()[rows], name)
    for name in ("boxes", "angles", "conf"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   getattr(ref, name).numpy()[rows], **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("devices", [
    ["cpu"] * 4, ["cpu", "cpu:0", "cpu", "cpu:0"], ["cpu:0", "cpu", "cpu"]],
    ids=["one_device", "two_devices", "uneven"])
def test_rung_row_move_equals_indexing_all_rows(devices):
    """A rung's row move over several shards (``engine.cascade._take``)
    equals indexing all rows at once and splitting them into contiguous
    blocks, in order, field by field. ``cpu`` and ``cpu:0`` are distinct
    devices to the mesh, so the second and third cases take the route of a
    mesh of distinct cards; empty and None fields pass through."""
    devices = [torch.device(d) for d in devices]
    rng = np.random.RandomState(5)
    sizes = rng.randint(0, 30, len(devices))
    sizes[0] += 3
    offsets = np.cumsum([0] + list(sizes))
    n = int(offsets[-1])
    full = {k: torch.from_numpy(rng.randn(n, 3).astype(np.float32))
            for k in t_cascade._ROWS}
    full["mask"] = torch.from_numpy(rng.rand(n) < 0.5)
    full["img_idx"] = torch.from_numpy(rng.randint(0, 4, n))
    full["levels"] = None
    rows = [{k: None if v is None else v[a:b] for k, v in full.items()}
            for a, b in zip(offsets[:-1], offsets[1:])]
    for take in (n // 2, 2):            # two rows: some blocks get none
        idx = torch.from_numpy(rng.permutation(n)[:take])
        got = t_cascade._take(rows, idx, devices)
        assert len(got) == len(devices)
        for k, v in full.items():
            want = ([None] * len(devices) if v is None
                    else torch.tensor_split(v[idx], len(devices)))
            for j, (g, w) in enumerate(zip(got, want)):
                if w is None:
                    assert g[k] is None, (k, j)
                else:
                    assert torch.equal(g[k], w), (k, j)


@pytest.mark.parametrize("n_images", [1, 2], ids=["one_image", "fused"])
def test_sharded_cascade_both_rungs(production, n_images):
    """Both rungs fire (mid_compact 24, mid_compact2 12, below the real
    rows per image): the rungs rank all shards' rows together, so the
    sharded run keeps the unsharded run's rows. A rung per shard would keep
    each shard's best 3 and then 1 or 2 rows instead.

    Selected rows are equal exactly; boxes, angles and confidences within
    the JAX tolerance, because here a shard holds 1 to 3 rows after the
    rungs and MKL computes products of 1 or 2 rows (networks) and under 8
    rows (the Gaussian quadratic form) with another kernel, which differs
    in the last bit from the same rows inside a taller product.

    One image: also against JAX's unsharded run. Fused (the per-image
    rung): each image's 12 rows against the port's one-image run of that
    image. The second image of this pair parts from JAX by 70 px in the
    one-image runs of both packages already, mesh or not (a last-bit
    difference of the random weights' products flips a nearest texel and
    then a rung's choice; ROADMAP.md section 3), so the fused run is not
    held against JAX here; tests/test_torch_batch.py holds the fused
    cascade against JAX on the shipped artifacts."""
    jm, tm = production
    jcfg, tcfg, args, fused, imgs = _production_inputs(production, n_images)
    plain = t_cascade.run_cascade(*args, **fused)
    sharded = t_mesh.sharded_cascade(t_mesh.make_mesh(N_DEV, device="cpu"),
                                     *args, **fused)
    assert sharded.mask.shape[0] == plain.mask.shape[0] == 12 * n_images
    assert int(plain.mask.sum()) > 0
    _assert_same_rows(sharded, plain)
    if n_images == 1:
        geom = jm.spec.face_geom
        js, _, _ = j_cascade.make_grid_state(112, 96, geom, jcfg)
        _assert_state(sharded, j_cascade.run_cascade(
            jm.plan, jm.det_specs, geom, jcfg, args[4], jnp.asarray(imgs[0]),
            jm.det_params, jm.det_clfs, js))
        return
    np.testing.assert_array_equal(sharded.img_idx.numpy(),
                                  np.repeat(np.arange(n_images), 12))
    _, _, one, _, _ = _production_inputs(production, 1)
    for i in range(n_images):
        ref = t_cascade.run_cascade(*one[:5], torch.from_numpy(imgs[i]),
                                    *one[6:])
        block = t_cascade.CascadeState(*(
            None if v is None else v[12 * i: 12 * (i + 1)]
            for v in sharded))
        _assert_same_rows(block, ref)


def test_sharded_gsfa_step_matches_jax():
    """test_parallel.py:59-77: gsfa_step and sharded_gsfa_step on a 4 x 2
    mesh, against JAX's."""
    x = np.random.RandomState(1).randn(64, 8, 6).astype(np.float32)
    jmean, jW = j_step.gsfa_step(jnp.asarray(x), out_dim=3)
    jmean_s, jW_s = j_step.sharded_gsfa_step(
        j_mesh.make_mesh(N_DEV, ("data", "model"), shape=(4, 2)), x, 3)
    mesh = t_mesh.make_mesh(N_DEV, ("data", "model"), shape=(4, 2),
                            device="cpu")
    tmean, tW = t_step.gsfa_step(torch.from_numpy(x), 3)
    tmean_s, tW_s = t_step.sharded_gsfa_step(mesh, x, 3)
    for mean, W in ((tmean, tW), (tmean_s, tW_s)):
        for want_mean, want_W in ((jmean, jW), (jmean_s, jW_s)):
            np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean),
                                       rtol=1e-4, atol=1e-5)
            got, want = W.numpy(), np.asarray(want_W)
            sign = np.sign(np.sum(got * want, axis=-2, keepdims=True))
            np.testing.assert_allclose(got * sign, want, rtol=1e-2,
                                       atol=1e-3)


def _canonical_corr(a, b, k=5):
    """Canonical correlations of the first ``k`` features of two nets
    (invariant to sign and rotation inside near-degenerate blocks)."""
    def q(f):
        f = f[:, :k]
        f = (f - f.mean(0)) / (f.std(0) + 1e-9)
        return np.linalg.qr(f)[0]
    return np.linalg.svd(q(a).T @ q(b), compute_uv=False)


def _port_features(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("graph", ["serial", "clustered"])
def test_mesh_trainer_matches_jax(graph):
    """test_parallel.py:80-151: the production train_network under an
    8-device data mesh. The moments of the sharded batch equal JAX's on its
    sharded batch; the mesh-trained net computes the unsharded net's
    feature space.

    The feature spaces are not held against JAX's trainer: it accumulates
    float32 moments, and on this serial set its 4th and 5th features sit
    at canonical correlations of 0.69 and 0.05 from a float64 reference
    (the port's, which accumulates float64, at 1.0; see
    ``training.trainer.train_network``). Its clustered set agrees to 1.0
    and is held against JAX."""
    rng = np.random.RandomState(7)
    n = 32 * N_DEV
    lab = rng.rand(n)
    x = (np.outer(lab, rng.randn(256)) +
         0.3 * rng.randn(n, 256)).astype(np.float32)
    labels, groups = ((lab, 8) if graph == "serial"
                      else ((lab * 8).astype(int), 8))
    jmesh = j_mesh.make_mesh(N_DEV, ("data",))
    tmesh = t_mesh.make_mesh(N_DEV, device="cpu")
    # The distributed reduction itself, on the first layer's fields.
    xj = x.reshape(n, 16, 16)[:, :4, :4].reshape(n, 1, 16)
    from jax.sharding import NamedSharding, PartitionSpec as P
    want = j_moments.gsfa_moments(
        jax.device_put(xj, NamedSharding(jmesh, P("data", None, None))),
        graph, labels=labels, num_groups=groups)
    got = t_moments.gsfa_moments(t_mesh.shard_batch(tmesh,
                                                    torch.from_numpy(xj)),
                                 graph, labels=labels, num_groups=groups)
    for name, g, w in zip(("mean", "B", "A"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MOMENT_TOL,
                                   err_msg=f"{graph} {name}")
    # End to end: the mesh-trained net's feature space is the unsharded
    # net's (test_parallel.py:133-151).
    def net():
        return t_builder.build_higsfa(16, base_field=4, d=6, top_dim=8)
    kw = dict(graph=graph, labels=labels, num_groups=groups)
    sharded = _port_features(t_step.sharded_train_network(
        tmesh, net(), torch.from_numpy(x), **kw), x)
    plain = _port_features(t_trainer.train_network(
        net(), torch.from_numpy(x), verbose=False, **kw), x)
    cc = _canonical_corr(plain, sharded)
    assert cc.mean() > 0.98 and cc.min() > 0.9, f"{graph}: {cc}"
    if graph == "clustered":
        jnet = j_trainer.train_network(
            j_builder.build_higsfa(16, base_field=4, d=6, top_dim=8), x,
            verbose=False, **kw)
        cc = _canonical_corr(np.asarray(jax.jit(jnet.execute)(x)), sharded)
        assert cc.mean() > 0.98 and cc.min() > 0.9, f"JAX: {cc}"


def test_mesh_trainer_temporal_halo_and_truncation():
    """Temporal moments (and the PCA nodes' mean and covariance) over 3
    uneven row blocks (100 rows) equal JAX's unsharded ones: every block
    boundary keeps its difference (the one-row halo). train_network on a
    3-device mesh cuts samples AND labels to 99 rows and trains what the
    unsharded trainer trains on those rows."""
    rng = np.random.RandomState(11)
    n = 100
    lab = rng.rand(n)
    x = (np.outer(lab, rng.randn(256)) +
         0.3 * rng.randn(n, 256)).astype(np.float32)
    x3 = x.reshape(n, 16, 16)[:, :4, :4].reshape(n, 1, 16)
    blocks = list(torch.tensor_split(torch.from_numpy(x3), 3))
    assert [b.shape[0] for b in blocks] == [34, 33, 33]
    want = j_moments.gsfa_moments(jnp.asarray(x3), "temporal")
    got = t_moments.gsfa_moments(blocks, "temporal")
    for name, g, w in zip(("mean", "B", "A"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MOMENT_TOL,
                                   err_msg=name)
    # The PCA nodes' moments over the same blocks.
    for name, g, w in zip(("mean", "cov"), t_moments.mean_cov(blocks),
                          j_moments.mean_cov(jnp.asarray(x3))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MOMENT_TOL,
                                   err_msg=name)
    mesh = t_mesh.make_mesh(3, device="cpu")
    for graph, labels in (("temporal", None), ("serial", lab)):
        net = t_builder.build_higsfa(16, base_field=4, d=6, top_dim=8)
        sharded = t_trainer.train_network(net, torch.from_numpy(x),
                                          graph=graph, labels=labels,
                                          num_groups=8, verbose=False,
                                          mesh=mesh)
        plain = t_trainer.train_network(
            net, torch.from_numpy(x[:99]), graph=graph,
            labels=None if labels is None else labels[:99], num_groups=8,
            verbose=False)
        cc = _canonical_corr(_port_features(plain, x),
                             _port_features(sharded, x))
        assert cc.mean() > 0.98 and cc.min() > 0.9, f"{graph}: {cc}"


def _same_detections(got, want, atol=1e-4):
    """Per-batch, per-image detection lists: equal counts, boxes and
    confidences within ``atol`` (test_parallel.py:172-180)."""
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        assert [len(d) for d in gb] == [len(d) for d in wb]
        for gi, wi in zip(gb, wb):
            for g, w in zip(gi, wi):
                np.testing.assert_allclose(g.box, w.box, atol=atol)
                np.testing.assert_allclose(g.confidence, w.confidence,
                                           atol=atol)


def test_detect_stream_mesh_matches_unsharded(production):
    """test_parallel.py:154-180 on the toy production model: detect_stream
    of a data_mesh=8 detector equals the port's unsharded detector built
    with the same bucket shapes. (Against JAX's toy detector the port's
    unsharded and sharded detectors both differ by 1.7e-3 px on these
    scenes: the random weights amplify a 4e-6 px difference of the two
    frameworks' f32 products after stage 2 stage by stage, mesh or not,
    ROADMAP.md section 3; test_detect_stream_mesh_matches_jax_shipped
    holds the mesh against JAX on the shipped artifacts.)"""
    _, tm = production
    rng = np.random.RandomState(7)
    batches = [[rng.rand(96, 112).astype(np.float32) for _ in range(2)]
               for _ in range(2)]
    det = t_detector.FaceDetector(tm, t_dryrun._toy_config(
        N_DEV, N_DEV, matmul_dtype="f32"), device="cpu")
    assert len(det._mesh.axis_devices("data")) == N_DEV
    single = t_detector.FaceDetector(tm, t_dryrun._toy_config(
        0, N_DEV, matmul_dtype="f32"), device="cpu")
    assert single._mesh is None
    got = list(det.detect_stream(iter(batches), estimate_attributes=False))
    want = [single.detect_batch(b, estimate_attributes=False)
            for b in batches]
    assert sum(len(d) for b in got for d in b) > 0
    _same_detections(got, want)


def test_detect_stream_mesh_matches_jax_shipped():
    """detect_stream of a data_mesh=8 detector against JAX's data_mesh=8
    stream on the shipped artifacts and three rendered scenes
    (tests/test_torch_batch.py's SCENES; f32 operands and wire), and
    against the port's unsharded detect_batch."""
    from test_torch_batch import ART, SCENES
    from test_torch_detect import _scene

    scenes = [_scene(s) for s in SCENES]
    batches = [scenes[:2], scenes[2:] + scenes[:1]]
    kw = dict(matmul_dtype="f32", wire_format="f32")
    jm = j_detector.DetectionModel.load(ART)
    tm = t_detector.DetectionModel.load(ART, device="cpu")
    want = list(j_detector.FaceDetector(
        jm, JConfig(data_mesh=N_DEV, **kw)).detect_stream(
            iter(batches), estimate_attributes=False))
    det = t_detector.FaceDetector(tm, TConfig(data_mesh=N_DEV, **kw),
                                  device="cpu")
    got = list(det.detect_stream(iter(batches), estimate_attributes=False))
    assert sum(len(d) for b in got for d in b) > 0
    _same_detections(got, want)
    single = t_detector.FaceDetector(tm, TConfig(**kw), device="cpu")
    _same_detections(got, [single.detect_batch(b, estimate_attributes=False)
                           for b in batches])


def test_dryrun_multichip_entry():
    """The port's dry run executes on 8 CPU copies."""
    t_dryrun.dryrun_multichip(N_DEV, "cpu")
