"""The alignment evaluator, the localization cycle and the loop verifier of
the port (``ops/registration.py::evaluate_alignment``, ``register_and_score``,
``backend/loop_closure.py``) against the reference, on the CPU.

Room features of ``tests/test_torch_registration.py`` (16 × 360 scan, 768
edge and up to 1920 surf features). ``evaluate_alignment`` fits a plane to
five neighbours, the fit that is ill-conditioned in float32 (see that file),
so the reference is evaluated in float64 (``jax.enable_x64``): score rtol
1e-4 (float32 distances from the k-NN against float64 ones), overlap exact.
The reference's ``_verify_fused`` cannot be traced in float64 (its
``lax.cond`` mixes a float32 constant with the float64 score), so the
verifier is held against the same two stages composed by hand from the
float64 reference functions, and against the float32 ``_verify_fused`` for
the side of the gate and the score to 1e-2 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsf_slam_tpu.backend import loop_closure as jlc
from lmsf_slam_tpu.common import se3 as jse3
from lmsf_slam_tpu.ops import registration as jr
from lmsf_slam_tpu_torch.backend import loop_closure as plc
from lmsf_slam_tpu_torch.common import se3np
from lmsf_slam_tpu_torch.common.pointcloud import PointBatch as PPB
from lmsf_slam_tpu_torch.ops import registration as pr
from tests.test_torch_registration import CASES, _pose, _room, assert_result, reference_f64, to_port
from tests import torch_threads  # noqa: F401


def _offset(pose, dw, dt):
    """``pose`` perturbed on the right by a small twist, float32."""
    return np.asarray(se3np.pose_compose(np.asarray(pose, np.float64),
                                         se3np.se3_exp(np.array(dw + dt))), np.float32)


@pytest.fixture(scope="module")
def room():
    _, feats, src_e, src_s, _ = _room(0)
    return feats, src_e, src_s, np.asarray(_pose(*CASES[0]))


OFFSETS = {
    "aligned": ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
    "5cm": ([0.0, 0.0, 0.01], [0.05, -0.03, 0.01]),
    "40cm": ([0.0, 0.0, 0.05], [0.4, 0.2, 0.0]),
    "2m": ([0.0, 0.0, 0.3], [2.0, -1.5, 0.0]),
}


@pytest.mark.parametrize("name", sorted(OFFSETS))
def test_evaluate_alignment_matches_reference(room, name):
    feats, _, src_s, true_pose = room
    pose = _offset(true_pose, *OFFSETS[name])
    for min_overlap in (0.2, 0.95):
        want_s, want_o = reference_f64(jr.evaluate_alignment, src_s, feats.surf, pose,
                                       min_overlap=min_overlap)
        got_s, got_o = pr.evaluate_alignment(to_port(src_s), to_port(feats.surf),
                                             torch.as_tensor(pose), min_overlap=min_overlap)
        assert got_s.dtype == torch.float32 and got_s.ndim == 0
        assert float(got_o) == pytest.approx(float(want_o), abs=1e-7)
        np.testing.assert_allclose(float(got_s), float(want_s), rtol=1e-4)
    if name == "aligned":
        assert float(got_o) > 0.99 and float(pr.evaluate_alignment(
            to_port(src_s), to_port(feats.surf), torch.as_tensor(pose))[0]) < 1e-3


def test_evaluate_alignment_of_disjoint_clouds_is_the_sentinel(room):
    feats, _, src_s, true_pose = room
    far = PPB(to_port(src_s).xyz + 300.0, to_port(src_s).mask)
    score, overlap = pr.evaluate_alignment(far, to_port(feats.surf), torch.as_tensor(true_pose))
    assert float(score) == 1e9 and float(overlap) == 0.0
    want_s, want_o = jr.evaluate_alignment(
        type(src_s)(src_s.xyz + 300.0, src_s.mask), feats.surf, jnp.asarray(true_pose))
    assert float(want_s) == 1e9 and float(want_o) == 0.0
    # an empty source and an empty map give the sentinel too, and stay finite
    empty = PPB.empty(16, device="cpu")
    for src, ref in ((empty, to_port(feats.surf)), (to_port(src_s), empty)):
        score, overlap = pr.evaluate_alignment(src, ref, torch.as_tensor(true_pose))
        assert float(score) == 1e9 and float(overlap) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_register_and_score_matches_reference(seed):
    _, feats, src_e, src_s, _ = _room(seed)
    ident = np.asarray(jse3.pose_identity())
    kw = dict(max_iters=8, max_corr_dist=2.0)
    want, want_s, want_o = reference_f64(
        jr.register_and_score, src_e, src_s, feats.edge, feats.surf, ident,
        params=jr.RegistrationParams(**kw), min_overlap=0.1)
    got, got_s, got_o = pr.register_and_score(
        to_port(src_e), to_port(src_s), to_port(feats.edge), to_port(feats.surf),
        torch.as_tensor(ident), pr.RegistrationParams(**kw), min_overlap=0.1)
    assert_result(got, want)
    assert float(got_o) == pytest.approx(float(want_o), abs=1e-7)
    np.testing.assert_allclose(float(got_s), float(want_s), rtol=1e-3, atol=1e-7)


def _reference_verify64(src_e, src_s, feats, init, cfg, rough_thresh):
    """The two stages of the reference's ``_verify_fused`` composed from its
    float64 functions: (pose, score, overlap, converged, n_constrained,
    rough_score)."""
    rough = reference_f64(jr.register_edge_surf, src_e, src_s, feats.edge, feats.surf, init,
                          params=cfg.rough_params)
    r_score, r_overlap = reference_f64(jr.evaluate_alignment, src_s, feats.surf, rough.pose,
                                       min_overlap=cfg.min_overlap)
    if r_score > rough_thresh:
        return rough.pose, 1e9, float(r_overlap), False, 0, float(r_score)
    ref = reference_f64(jr.register_edge_surf, src_e, src_s, feats.edge, feats.surf,
                        np.asarray(rough.pose, np.float32), params=cfg.refine_params)
    s, o = reference_f64(jr.evaluate_alignment, src_s, feats.surf, ref.pose,
                         min_overlap=cfg.min_overlap)
    return ref.pose, float(s), float(o), bool(ref.converged), int(ref.n_constrained), float(r_score)


@pytest.mark.parametrize("rough_thresh", [1.0, 1e-7], ids=["gate-passes", "gate-fails"])
def test_verify_fused_on_both_sides_of_the_rough_gate(room, rough_thresh):
    feats, src_e, src_s, true_pose = room
    init = _offset(true_pose, [0.0, 0.0, 0.08], [0.5, -0.4, 0.0])
    pcfg, jcfg = plc.LoopConfig(), jlc.LoopConfig()
    got = plc._verify_fused(
        to_port(src_e), to_port(src_s), to_port(feats.edge), to_port(feats.surf),
        torch.as_tensor(init), pcfg.rough_params, pcfg.refine_params, rough_thresh,
        pcfg.min_overlap)
    pose, score, overlap, conv, ncon, r_score = (g.numpy() for g in got)
    w_pose, w_score, w_overlap, w_conv, w_ncon, w_rscore = _reference_verify64(
        src_e, src_s, feats, init, jcfg, rough_thresh)
    np.testing.assert_allclose(pose, w_pose, atol=1e-5)
    np.testing.assert_allclose(float(score), w_score, rtol=1e-3)
    assert float(overlap) == pytest.approx(w_overlap, abs=1e-7)
    assert (bool(conv), int(ncon)) == (w_conv, w_ncon)
    np.testing.assert_allclose(float(r_score), w_rscore, rtol=1e-3)
    # the float32 reference, as it runs: the same side of the gate
    ref32 = jlc._verify_fused(src_e, src_s, feats.edge, feats.surf, jnp.asarray(init),
                              jcfg.rough_params, jcfg.refine_params,
                              jnp.float32(rough_thresh), jnp.float32(jcfg.min_overlap))
    assert (float(ref32[5]) <= rough_thresh) == (float(r_score) <= rough_thresh)
    np.testing.assert_allclose(float(score), float(ref32[1]), rtol=1e-2)
    if rough_thresh == 1.0:
        assert bool(conv) and int(ncon) == 6 and float(score) < 0.05
        np.testing.assert_allclose(pose[4:], true_pose[4:], atol=0.02)
    else:
        assert float(score) == 1e9 and not bool(conv) and int(ncon) == 0


@pytest.mark.parametrize("kw", [{}, dict(refine_score_thresh=0.3, loop_info_best_scale=0.5)],
                         ids=["defaults", "relaxed"])
def test_edge_noise_matches_reference(kw):
    p, j = plc.LoopDetector(plc.LoopConfig(**kw)), jlc.LoopDetector(jlc.LoopConfig(**kw))
    for score in (0.0, 0.005, 0.01, 0.03, 0.05, 0.2, 0.3, 5.0):
        np.testing.assert_allclose(p.edge_noise(score), j.edge_noise(score), rtol=1e-12)
    assert p.edge_noise(0.0)[3] < p.edge_noise(1.0)[3]


def test_loop_config_and_results_match_reference():
    assert plc.LoopConfig()._asdict() == jlc.LoopConfig()._asdict()
    assert plc.LoopResult._fields == jlc.LoopResult._fields
    assert plc.RelocResult._fields == jlc.RelocResult._fields
