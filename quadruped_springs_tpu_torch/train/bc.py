"""Behaviour-cloning pre-training for the PPO-imitation stage.

Port of ``quadruped_springs_tpu.train.bc``. Demonstration rows carry the
whole robot state, so each row's observation is rebuilt by an exact-state
reset (``env.reset(desired_robot_state=...)``, all rows in one batched
reset) and the policy mean is regressed onto the recorded actions.
"""

from __future__ import annotations

import torch

from quadruped_springs_tpu_torch.train import normalize as vnorm
from quadruped_springs_tpu_torch.utils import demo as demo_util


@torch.no_grad()
def demo_dataset(env, demo: torch.Tensor, generator: torch.Generator):
    """(obs (T, obs_dim), actions (T, A)) with the causal pairing: the state
    before each action maps to that action. A demo row records the state
    after its action was applied, so row t-1's state pairs with action t,
    and the clean reset state pairs with action 0; pairing rows with their
    own actions would clone a controller delayed by one step."""
    demo = torch.as_tensor(demo, dtype=torch.float32, device=env.device)
    n = demo.shape[0]
    acts = demo_util.demo_actions(demo, env.action_dim)
    idx = torch.arange(n - 1, device=env.device)
    rs = demo_util.demo_robot_state(demo, idx, env.action_dim)
    _, row_obs = env.reset(generator, desired_robot_state=rs, demo_start_idx=idx)
    _, reset_obs = env.reset(generator, 1)
    return torch.cat([reset_obs, row_obs], dim=0), acts


def fit(net, obs: torch.Tensor, acts: torch.Tensor, iters: int = 3000, lr: float = 1e-3,
        log_std: float = -1.5):
    """Full-batch Adam regression of the actor mean of `net` (a fresh
    MLPPolicy, trained in place) onto the demo actions. Returns (net,
    obs_norm, final mse: the loss before the last update). The critic tower
    stays at its initialisation; log_std is set to the given exploration
    level for the PPO polish."""
    obs_norm = vnorm.update(vnorm.RunningNorm.create(obs.shape[1], obs.device), obs)
    obs_n = vnorm.normalize(obs_norm, obs)
    actor = [p for name, p in net.named_parameters() if name.startswith("pi_")]
    opt = torch.optim.Adam(actor, lr=lr, eps=1e-8)
    loss = torch.zeros((), device=obs.device)
    for _ in range(iters):
        loss = ((net(obs_n)[0] - acts) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    with torch.no_grad():
        net.log_std.fill_(log_std)
    return net, obs_norm, loss.detach()
