"""Pose-graph Gauss-Newton: drift correction with loop closures."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from caelo_tpu.backend.posegraph import (PoseGraph, concat_graphs,
                                         odometry_graph, optimize,
                                         optimize_sharded)
from caelo_tpu.geometry import se3


def make_square_trajectory(n_side=5, step=1.0):
    """Ground truth: a closed square path with yaw turns at corners."""
    Rs, ts = [np.eye(3)], [np.zeros(3)]
    R, t = np.eye(3), np.zeros(3)
    for leg in range(4):
        for _ in range(n_side):
            t = t + R @ np.array([step, 0, 0])
            Rs.append(R.copy())
            ts.append(t.copy())
        R = R @ Rotation.from_euler("z", 90, degrees=True).as_matrix()
        Rs.append(R.copy())
        ts.append(t.copy())
    return np.array(Rs), np.array(ts)


def rels_from(Rs, ts, noise_rot=0.0, noise_t=0.0, rng=None):
    rel_R, rel_t = [], []
    for i in range(len(Rs) - 1):
        dR = Rs[i].T @ Rs[i + 1]
        dt = Rs[i].T @ (ts[i + 1] - ts[i])
        if rng is not None:
            dR = dR @ Rotation.from_rotvec(
                rng.normal(0, noise_rot, 3)).as_matrix()
            dt = dt + rng.normal(0, noise_t, 3)
        rel_R.append(dR)
        rel_t.append(dt)
    return np.array(rel_R), np.array(rel_t)


def chain(rel_R, rel_t):
    Rs, ts = [np.eye(3)], [np.zeros(3)]
    for dR, dt in zip(rel_R, rel_t):
        ts.append(ts[-1] + Rs[-1] @ dt)
        Rs.append(Rs[-1] @ dR)
    return np.array(Rs), np.array(ts)


def test_exp_log_so3_roundtrip(rng):
    w = rng.normal(size=(20, 3)) * 0.8
    R = se3.exp_so3(jnp.asarray(w))
    w2 = np.asarray(se3.log_so3(R))
    np.testing.assert_allclose(w2, w, atol=1e-5)
    # near-zero stability
    w0 = jnp.asarray([[1e-9, 0, 0]])
    np.testing.assert_allclose(np.asarray(se3.exp_so3(w0))[0], np.eye(3), atol=1e-8)


def test_optimize_exact_graph_stays_put():
    Rs, ts = make_square_trajectory()
    rel_R, rel_t = rels_from(Rs, ts)
    g = odometry_graph(rel_R, rel_t)
    R, t, cost = optimize(jnp.asarray(Rs), jnp.asarray(ts), g, n_iters=3)
    np.testing.assert_allclose(np.asarray(t), ts, atol=1e-4)
    assert float(cost) < 1e-8


def test_loop_closure_corrects_drift(rng):
    """Noisy odometry + one exact loop edge: the loop endpoints must be
    pulled (nearly) together while pure odometry leaves a gap."""
    Rs, ts = make_square_trajectory()
    rel_R, rel_t = rels_from(Rs, ts, noise_rot=0.004, noise_t=0.03, rng=rng)
    R_init, t_init = chain(rel_R, rel_t)
    n = len(R_init)
    gap_before = np.linalg.norm(t_init[-1] - ts[-1])
    assert gap_before > 0.05  # drift exists

    odo = odometry_graph(rel_R, rel_t)
    # exact loop edge: last node == first node pose (closed square)
    loop = PoseGraph(
        edge_i=jnp.asarray([0], jnp.int32),
        edge_j=jnp.asarray([n - 1], jnp.int32),
        rel_R=jnp.asarray(Rs[0].T @ Rs[-1])[None],
        rel_t=jnp.asarray(Rs[0].T @ (ts[-1] - ts[0]))[None],
        weight=jnp.asarray([50.0]),
        rot_info=jnp.asarray([100.0]),
    )
    g = concat_graphs(odo, loop)
    R, t, cost = optimize(jnp.asarray(R_init), jnp.asarray(t_init), g,
                          n_iters=8, cg_iters=60)
    t = np.asarray(t)
    gap_after = np.linalg.norm(t[-1] - ts[-1])
    assert gap_after < 0.35 * gap_before
    # overall trajectory error reduced
    err_before = np.linalg.norm(t_init - ts, axis=1).mean()
    err_after = np.linalg.norm(t - ts, axis=1).mean()
    assert err_after < err_before


def test_optimize_host_exact_graph_stays_put():
    from caelo_tpu.backend.posegraph import optimize_host

    Rs, ts = make_square_trajectory()
    rel_R, rel_t = rels_from(Rs, ts)
    g = odometry_graph(rel_R, rel_t)
    R, t, cost = optimize_host(Rs, ts, g)
    np.testing.assert_allclose(t, ts, atol=1e-9)
    assert cost < 1e-18


def test_optimize_host_collapses_loop_drift(rng):
    """The direct f64 sparse GN must CONVERGE (unlike iteration-starved CG):
    on noisy odometry + one exact loop edge, the endpoint gap collapses to
    ~noise scale and the solve beats the device-CG result."""
    from caelo_tpu.backend.posegraph import optimize_host

    Rs, ts = make_square_trajectory()
    rel_R, rel_t = rels_from(Rs, ts, noise_rot=0.004, noise_t=0.03, rng=rng)
    R_init, t_init = chain(rel_R, rel_t)
    n = len(R_init)
    gap_before = np.linalg.norm(t_init[-1] - ts[-1])
    loop = PoseGraph(
        edge_i=jnp.asarray([0], jnp.int32),
        edge_j=jnp.asarray([n - 1], jnp.int32),
        rel_R=jnp.asarray(Rs[0].T @ Rs[-1])[None],
        rel_t=jnp.asarray(Rs[0].T @ (ts[-1] - ts[0]))[None],
        weight=jnp.asarray([50.0]),
        rot_info=jnp.asarray([100.0]),
    )
    g = concat_graphs(odometry_graph(rel_R, rel_t), loop)
    R, t, cost = optimize_host(R_init, t_init, g)
    gap_after = np.linalg.norm(t[-1] - ts[-1])
    assert gap_after < 0.05 * gap_before
    err_before = np.linalg.norm(t_init - ts, axis=1).mean()
    err_after = np.linalg.norm(t - ts, axis=1).mean()
    assert err_after < 0.5 * err_before
    # rotations stay orthonormal through the retraction chain
    np.testing.assert_allclose(
        np.einsum("nij,nik->njk", R, R), np.tile(np.eye(3), (len(R), 1, 1)),
        atol=1e-10)


def test_optimize_host_matches_device_optimum():
    """On a small graph (where CG CAN converge) the host solve and the
    jitted device-path solve agree."""
    from caelo_tpu.backend.posegraph import optimize_host

    rng = np.random.default_rng(3)
    Rs, ts = make_square_trajectory(n_side=2)
    rel_R, rel_t = rels_from(Rs, ts, noise_rot=0.01, noise_t=0.05, rng=rng)
    R_init, t_init = chain(rel_R, rel_t)
    n = len(R_init)
    loop = PoseGraph(
        edge_i=jnp.asarray([0], jnp.int32),
        edge_j=jnp.asarray([n - 1], jnp.int32),
        rel_R=jnp.asarray(Rs[0].T @ Rs[-1])[None],
        rel_t=jnp.asarray(Rs[0].T @ (ts[-1] - ts[0]))[None],
        weight=jnp.asarray([10.0]),
        rot_info=jnp.asarray([100.0]),
    )
    g = concat_graphs(odometry_graph(rel_R, rel_t), loop)
    Rd, td, cd = optimize(jnp.asarray(R_init), jnp.asarray(t_init), g,
                          n_iters=10, cg_iters=200)
    Rh, th, ch = optimize_host(R_init, t_init, g)
    np.testing.assert_allclose(th, np.asarray(td), atol=2e-3)
    assert ch <= float(cd) * 1.05 + 1e-9


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_matches_single_device(rng):
    from caelo_tpu.parallel.mesh import make_mesh

    Rs, ts = make_square_trajectory(n_side=3)
    rel_R, rel_t = rels_from(Rs, ts, noise_rot=0.003, noise_t=0.02, rng=rng)
    R_init, t_init = chain(rel_R, rel_t)
    g = odometry_graph(rel_R, rel_t)
    # pad edges to a multiple of 8 with weight-0 edges
    E = g.edge_i.shape[0]
    pad = (-E) % 8
    gp = PoseGraph(
        edge_i=jnp.concatenate([g.edge_i, jnp.zeros(pad, jnp.int32)]),
        edge_j=jnp.concatenate([g.edge_j, jnp.zeros(pad, jnp.int32)]),
        rel_R=jnp.concatenate([g.rel_R, jnp.tile(jnp.eye(3), (pad, 1, 1))]),
        rel_t=jnp.concatenate([g.rel_t, jnp.zeros((pad, 3))]),
        weight=jnp.concatenate([g.weight, jnp.zeros(pad)]),
        rot_info=jnp.concatenate([g.rot_info, jnp.zeros(pad)]),
    )
    R1, t1, c1 = optimize(jnp.asarray(R_init), jnp.asarray(t_init), gp,
                          n_iters=4, cg_iters=40)
    mesh = make_mesh(n_data=8, n_model=1)
    solve = optimize_sharded(mesh, n_nodes=len(R_init), n_iters=4, cg_iters=40)
    R8, t8, c8 = solve(
        jnp.asarray(R_init, jnp.float32), jnp.asarray(t_init, jnp.float32),
        jax.tree.map(lambda x: jnp.asarray(x, jnp.float32) if x.dtype != jnp.int32 else x, gp),
    )
    np.testing.assert_allclose(np.asarray(t8), np.asarray(t1), atol=1e-2)
    # both solves converge to ~zero cost (f64 single vs f32 sharded)
    np.testing.assert_allclose(float(c8), float(c1), atol=1e-6)
