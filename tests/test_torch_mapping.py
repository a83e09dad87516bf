"""tpuslam_torch's dictionary, chunk dictionary, Mapper and loop closure
against tpuslam's.

Dictionary decisions are bit-equal: descriptor bytes held as f32 make
every squared-L2 term an integer below 2^24, so the matmul expansion is
exact in both packages (TF32 off).  The Mapper runs on
test_torch_fused.py's 12-frame sequence in SlamConfig() with a small
short-term memory and a low loop threshold, so that loop closure fires;
with tpuslam's RANSAC draws injected (VO and registration), the port
builds the same nodes, words, references and links.  Link transforms
agree to registration noise (1e-4 for loop closures, which the port
registers with the LM refine of kernel K6's plain version; 1e-3 for
odometry links, as test_torch_fused.py holds poses).  Information
matrices are inverse medians of point errors at the refined poses, and
move with them: they are held to 5 %.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tpuslam.config import SlamConfig, MapperConfig
from tpuslam_torch import convert


def _jax_draws(seed):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (300, 6)))


@pytest.fixture(scope="module")
def fwd_seq(tmp_path_factory):
    from tpuslam.io.synthetic import make_sequence
    from tpuslam.io.dataset import StereoImageDataset
    out = str(tmp_path_factory.mktemp("torch_mapseq"))
    make_sequence(out, n_frames=12, width=320, height=240, f=250.0,
                  baseline=0.54, speed=0.4, yaw_rate=0.002, seed=3)
    ds = StereoImageDataset(
        left_dir=os.path.join(out, "image_0"),
        right_dir=os.path.join(out, "image_1"),
        times_path=os.path.join(out, "times.txt"),
        gt_path=os.path.join(out, "poses.txt"))
    return [ds[i] for i in range(len(ds))]


def _camera(items):
    from tpuslam.geometry.camera import StereoCameraModel
    h, w = items[0]["left"].shape
    f, cx, cy, B = 250.0, (w - 1) / 2.0, (h - 1) / 2.0, 0.54
    P0 = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]], np.float64)
    P1 = P0.copy()
    P1[0, 3] = -f * B
    return StereoCameraModel(P_l=P0, P_r=P1, width=w, height=h)


def _cfg(**mapper):
    return dataclasses.replace(SlamConfig(), mapper=MapperConfig(
        map_update=2, **mapper))


LC_CFG = dict(max_stm_size=2, loop_thr=0.05)


def _port_run(items, cfg, mode, device_dict=True):
    from tpuslam_torch.mapping.mapper import Mapper
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    tcfg = convert.config_from_reference(cfg)
    cam = convert.camera_from_reference(_camera(items))
    mapper = Mapper(cam, tcfg.mapper, tcfg.matching, tcfg.pnp, device="cpu")
    mapper.draws_fn = _jax_draws
    mapper.async_lc = mode == "async"
    pipe = FastSlamPipeline(cam, tcfg, chunk=6, capacity=384,
                            draws_fn=_jax_draws, device="cpu",
                            device_dict=device_dict)
    if mode == "run":
        pipe.run(items, mapper=mapper)
    else:
        pipe.run_staged(pipe.stage_chunks(items), items, mapper=mapper,
                        mapper_async=mode == "async")
    if device_dict:
        assert pipe._dict_driver is not None
        assert not mapper.word_precomputed, "unconsumed decisions"
    return mapper


@pytest.fixture(scope="module")
def reference_mapper(fwd_seq):
    from tpuslam.mapping.mapper import Mapper
    from tpuslam.runtime.fast_pipeline import FastSlamPipeline
    cfg = _cfg(**LC_CFG)
    cam = _camera(fwd_seq)
    mapper = Mapper(cam, cfg.mapper, cfg.matching, cfg.pnp)
    FastSlamPipeline(cam, cfg, chunk=6, capacity=384).run(fwd_seq,
                                                          mapper=mapper)
    assert mapper.loop_closures, "the sequence must close loops"
    return mapper


def _assert_same_dictionary(a, b):
    assert a.vwd._count == b.vwd._count > 0
    assert a.vwd._last_word_id == b.vwd._last_word_id
    np.testing.assert_array_equal(a.vwd._train[:a.vwd._count],
                                  b.vwd._train[:b.vwd._count])
    np.testing.assert_array_equal(a.vwd._word_ids[:a.vwd._count],
                                  b.vwd._word_ids[:b.vwd._count])
    assert set(a.vwd.words) == set(b.vwd.words)
    for wid, vw in b.vwd.words.items():
        assert a.vwd.words[wid].references == vw.references
    assert sorted(a.nodes) == sorted(b.nodes)
    for nid in b.nodes:
        assert a.nodes[nid].words == b.nodes[nid].words


@pytest.mark.parametrize("mode", ["run", "sync", "async"])
def test_mapper_matches_reference(fwd_seq, reference_mapper, mode):
    got = _port_run(fwd_seq, _cfg(**LC_CFG), mode)
    ref = reference_mapper
    _assert_same_dictionary(got, ref)
    assert got.loop_closures == ref.loop_closures
    assert got.stm == ref.stm and got.working_mem == ref.working_mem
    pa, la = got.get_graph()
    pb, lb = ref.get_graph()
    assert sorted(pa) == sorted(pb)
    for k in pb:
        np.testing.assert_allclose(pa[k], pb[k], rtol=0, atol=1e-3)
    links_a, links_b = list(la.items()), list(lb.items())
    assert [(k, l.from_id, l.to_id, l.type) for k, l in links_a] == \
        [(k, l.from_id, l.to_id, l.type) for k, l in links_b]
    for (_, a), (_, b) in zip(links_a, links_b):
        loop = b.type == 1
        np.testing.assert_allclose(a.transform, b.transform, rtol=0,
                                   atol=1e-4 if loop else 1e-3)
        np.testing.assert_allclose(a.info, b.info, rtol=0.05)


def test_async_loop_closure_error_reaches_caller(fwd_seq, monkeypatch):
    """An error raised on the async loop-closure worker thread is raised
    by the run, not lost with the thread."""
    from tpuslam_torch.mapping.mapper import Mapper

    def fail(self, node):
        raise RuntimeError("loop-closure worker failed")

    monkeypatch.setattr(Mapper, "_dictionary_and_loop_closure", fail)
    with pytest.raises(RuntimeError, match="worker failed"):
        _port_run(fwd_seq[:4], _cfg(), "async")


def test_chunk_dictionary_equals_incremental(fwd_seq):
    """The port's per-chunk device dictionary against its incremental
    dictionary (tests/test_chunk_dict.py for tpuslam), with the per-node
    cap low enough that limit_keypoints runs."""
    cfg = _cfg(max_features_per_node=96)
    a = _port_run(fwd_seq, cfg, "sync", device_dict=False)
    b = _port_run(fwd_seq, cfg, "async", device_dict=True)
    _assert_same_dictionary(a, b)
    pa, la = a.get_graph()
    pb, lb = b.get_graph()
    assert sorted(pa) == sorted(pb) and len(la) == len(lb)


def _descriptor_batches(rng, n_nodes=5, n=120):
    """Descriptor batches with exact repeats and one-byte variants of
    earlier rows, so both the new-word and the add-reference branches
    run."""
    seen = []
    out = []
    for _ in range(n_nodes):
        d = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        if seen:
            old = np.concatenate(seen)
            pick = rng.choice(len(old), n // 2, replace=False)
            d[: n // 2] = old[pick]
            d[: n // 4, 0] ^= np.uint8(1)
        seen.append(d)
        out.append(d)
    return out


def test_dictionary_matches_reference(rng):
    from tpuslam.mapping.dictionary import VWDictionary as JD
    from tpuslam_torch.mapping.dictionary import VWDictionary
    j, t = JD(0.8), VWDictionary(0.8, device="cpu")
    for node_id, d in enumerate(_descriptor_batches(rng), start=1):
        assert t.add_new_words(d, node_id) == j.add_new_words(d, node_id)
    assert t._count == j._count and t._last_word_id == j._last_word_id
    assert {k: w.references for k, w in t.words.items()} == \
        {k: w.references for k, w in j.words.items()}
    # and a dictionary carried across from tpuslam goes on identically
    c = convert.dictionary_from_reference(j, device="cpu")
    d = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    d[:20] = j._train[:20].astype(np.uint8)
    assert c.add_new_words(d, 99) == j.add_new_words(d, 99)


def test_l2_top2_ids_matches_reference(rng):
    from tpuslam.mapping import dictionary as J
    from tpuslam_torch.mapping import dictionary as T
    train = rng.integers(0, 256, (512, 32)).astype(np.float32)
    train[100] = train[7]                            # a tie
    q = np.concatenate([train[[7, 3, 300]],
                        rng.integers(0, 256, (61, 32)).astype(np.float32)])
    ref = J._l2_top2_ids(jnp.asarray(q), jnp.asarray(train), jnp.int32(400))
    got = T._l2_top2_ids(torch.as_tensor(q), torch.as_tensor(train), 400)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_chunk_driver_matches_reference(rng, monkeypatch):
    """Two chunks of three full nodes through the port's ChunkDictDriver
    and through tpuslam's _chunk_dict_update: every decision and the word
    matrix bit-equal, response ties and an inactive node included."""
    from tpuslam.mapping.chunk_dict import _chunk_dict_update
    from tpuslam_torch.mapping.chunk_dict import ChunkDictDriver
    monkeypatch.setattr(ChunkDictDriver, "MIN_CAPACITY", 4096)
    K, C, mf = 3, 160, 96
    drv = ChunkDictDriver(0.8, mf, device="cpu")
    train = jnp.zeros((drv.capacity, 32), jnp.float32)
    count = jnp.int32(0)
    pool = rng.integers(0, 256, (200, 32), dtype=np.uint8)
    for chunk in range(2):
        descs = rng.integers(0, 256, (K, C, 32), dtype=np.uint8)
        descs[:, :60] = pool[rng.choice(200, (K, 60))]
        resps = np.round(rng.uniform(0, 4, (K, C)), 1).astype(np.float32)
        n_kpts = np.array([C, 130, 40], np.int32)
        active = [True, chunk == 0, True]
        train, count, ref = _chunk_dict_update(
            train, count, jnp.asarray(descs), jnp.asarray(resps),
            jnp.asarray(n_kpts), jnp.asarray(active), qcap=drv.qcap,
            nndr=0.8, max_features=mf)
        got = drv.fetch(drv.dispatch(torch.as_tensor(descs),
                                     torch.as_tensor(resps),
                                     torch.as_tensor(n_kpts), active))
        for k in ("keep", "unique", "i1", "count_after", "ok"):
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]), k)
        n = int(count)
        np.testing.assert_array_equal(drv.train[:n].numpy(),
                                      np.asarray(train)[:n])
    assert int(count) > 0


def test_pipeline_gives_no_device_dictionary_to_a_partitioned_mapper(
        fwd_seq, reference_mapper):
    """FastSlamPipeline starts its per-chunk device dictionary only for a
    mapper whose `device_dict_ok` is True, as tpuslam's does
    (tpuslam/runtime/fast_pipeline.py:121): a PartitionedMapper (rank 0
    of 1) searches its own sharded dictionary, gets no ChunkDictDriver,
    and makes tpuslam's decisions (its Mapper's, on this stream)."""
    from tpuslam_torch.dist.partitioned_map import PartitionedMapper
    from tpuslam_torch.mapping.mapper import Mapper
    from tpuslam_torch.runtime.fast_pipeline import FastSlamPipeline
    assert Mapper.device_dict_ok and not PartitionedMapper.device_dict_ok
    tcfg = convert.config_from_reference(_cfg(**LC_CFG))
    cam = convert.camera_from_reference(_camera(fwd_seq))
    pm = PartitionedMapper(cam, tcfg.mapper, tcfg.matching, tcfg.pnp,
                           rank=0, world=1, device="cpu")
    pm.draws_fn = _jax_draws
    pipe = FastSlamPipeline(cam, tcfg, chunk=6, capacity=384,
                            draws_fn=_jax_draws, device="cpu")
    assert pipe.device_dict
    pipe.run(fwd_seq, mapper=pm)
    assert pipe._dict_driver is None and not pm.word_precomputed
    _assert_same_dictionary(pm, reference_mapper)
    assert pm.loop_closures == reference_mapper.loop_closures
