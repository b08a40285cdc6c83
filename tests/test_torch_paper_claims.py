"""The paper's headline claims on the port, as ``tests/test_paper_claims.py``
states them for the JAX package: the same quadratic problems from the same
seeds (drawn by ``repro_torch.random``), the same rounds, step sizes and
thresholds, on the CPU.

* **Linear speed-up in M** (Thm 1/2): more clients → lower final ‖∇h‖
  under noise.
* **Communication efficiency** (Table 1): at an equal float budget,
  FedBiOAcc ends below FedBiO, and FedBiO below FedNest.
* **Local steps**: more local steps per round need fewer rounds to ε.
"""
import torch

from repro_torch import random as jr
from repro_torch.config import FederatedConfig
from repro_torch.core import make_algorithm, quadratic_problem

torch.set_num_threads(1)


def _grad_trajectory(prob, algo, rounds, *, local_steps=4, lr_x=0.03,
                     lr_y=0.1, lr_u=0.1, seed=2, **kw):
    cfg = FederatedConfig(algorithm=algo, num_clients=prob.num_clients,
                          local_steps=local_steps, lr_x=lr_x, lr_y=lr_y,
                          lr_u=lr_u, neumann_q=10, neumann_tau=0.15, **kw)
    alg = make_algorithm(prob, cfg)
    state = alg.init(jr.PRNGKey(1))
    key = jr.PRNGKey(seed)
    traj = []
    for _ in range(rounds):
        key, sub = jr.split(key)
        state, _ = alg.round(state, sub)
        traj.append(float(torch.linalg.norm(
            prob.exact_hypergrad(alg.mean_x(state)))))
    return traj, alg.comm_floats


def test_linear_speedup_in_clients():
    """Same per-client noise, same rounds: the M=16 run must end with a
    meaningfully lower tail-averaged gradient norm than M=2."""
    tails = {}
    for M in (2, 16):
        prob = quadratic_problem(jr.PRNGKey(0), num_clients=M, dx=10, dy=10,
                                 noise=1.2, hetero=0.6)
        traj, _ = _grad_trajectory(prob, "fedbio", rounds=150)
        tails[M] = sum(traj[-30:]) / 30
    assert tails[16] < 0.75 * tails[2], tails


def test_fedbioacc_beats_fedbio_per_communication():
    """At an equal float budget (FedBiOAcc sends twice FedBiO's floats a
    round, so FedBiO gets twice the rounds) FedBiOAcc ends lower."""
    prob = quadratic_problem(jr.PRNGKey(4), num_clients=8, dx=10, dy=10,
                             noise=0.6, hetero=1.0)
    traj_b, comm_b = _grad_trajectory(prob, "fedbio", rounds=600)
    traj_a, comm_a = _grad_trajectory(prob, "fedbioacc", rounds=300)
    assert comm_a == 2 * comm_b
    tail_b = sum(traj_b[-30:]) / 30
    tail_a = sum(traj_a[-30:]) / 30
    assert tail_a < tail_b, (tail_a, tail_b)


def test_fednest_needs_more_communication():
    """FedNest communicates ~(N_y + N_u + 1)× more floats a round; at a
    fixed communication budget FedBiO reaches a lower error."""
    prob = quadratic_problem(jr.PRNGKey(4), num_clients=8, dx=10, dy=10,
                             noise=0.3)
    traj_f, comm_f = _grad_trajectory(prob, "fednest", rounds=30)
    traj_b, comm_b = _grad_trajectory(prob, "fedbio",
                                      rounds=30 * comm_f // 30 // 1)
    ratio = comm_f / comm_b
    assert ratio > 2.0, ratio
    traj_b, _ = _grad_trajectory(prob, "fedbio", rounds=int(30 * ratio))
    assert sum(traj_b[-10:]) / 10 < sum(traj_f[-10:]) / 10 * 1.1


def test_more_local_steps_fewer_rounds():
    """Increasing I reduces the communication rounds needed to reach a
    fixed accuracy."""
    prob = quadratic_problem(jr.PRNGKey(6), num_clients=8, dx=10, dy=10,
                             noise=0.3)
    target_rounds = {}
    for I in (1, 8):
        traj, _ = _grad_trajectory(prob, "fedbio", rounds=200, local_steps=I)
        eps = 0.5 * traj[0]
        target_rounds[I] = next((i for i, g in enumerate(traj) if g < eps),
                                len(traj))
    assert target_rounds[8] < target_rounds[1], target_rounds
