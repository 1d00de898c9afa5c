"""PPO: the stage-2 trainer.

Port of ``quadruped_springs_tpu.train.ppo``: clipped-surrogate PPO with GAE,
a Gaussian MLP policy, running observation normalisation and minibatched
epochs. The rollout steps the batched environment under
``torch.no_grad()``; gradients flow through the network only. The optimiser
is ``clip_grad_norm_(max_grad_norm)`` then ``torch.optim.Adam(lr)`` (with
its step count on the device, so a train step reads nothing on the host).

Against optax: Adam's defaults agree (b1 0.9, b2 0.999, eps 1e-8 outside
the root); optax clips by g·min(1, max_norm / norm), ``clip_grad_norm_`` by
g·min(1, max_norm / (norm + 1e-6)): a relative 1e-6 / norm on a clipped
gradient.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch

from quadruped_springs_tpu_torch.env.env import take
from quadruped_springs_tpu_torch.train import normalize as vnorm
from quadruped_springs_tpu_torch.train import rollout as ro
from quadruped_springs_tpu_torch.train.networks import MLPPolicy, gaussian_logp


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_envs: int = 32
    segment_len: int = 64
    n_epochs: int = 4
    n_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    reset_bank_size: int = 32
    hidden: tuple = (64, 64)
    # when > 0, minibatch updates are masked out (parameters and optimiser
    # state frozen) for the rest of the train_step once the KL estimate of a
    # minibatch exceeds this: the brake on fine-tuning a warm-started policy
    kl_stop: float = 0.0
    # critic warm-up for stage transitions: train only the value head
    # (policy-gradient and entropy terms zeroed)
    freeze_actor: bool = False
    # freeze the running observation statistics: essential when warm-starting
    # from a cloned policy, whose statistics carry the count of one demo
    freeze_obs_norm: bool = False
    # temporal correlation of the exploration noise: eps_t = rho·eps_{t-1} +
    # sqrt(1 - rho²)·nu_t (0 = white). The marginal stays N(mean, sigma), so
    # the stored logp is exact per step.
    noise_rho: float = 0.0
    # anchored polish: adds anchor_coef·mean((mu(s) - mu_anchor(s))²) over
    # the rollout's states, the anchor set by PPOTrainer.set_anchor()
    anchor_coef: float = 0.0
    # BC-anchored polish: adds bc_coef·mse(mu(demo_obs), demo_actions) over
    # the fixed demo dataset (PPOTrainer.set_bc_anchor) to every update
    bc_coef: float = 0.0


@dataclasses.dataclass(frozen=True)
class PPOState:
    net: MLPPolicy                 # updated in place by train_step
    optimizer: torch.optim.Adam    # likewise
    obs_norm: vnorm.RunningNorm
    env_states: object             # batched env state, n_envs lanes
    obs: torch.Tensor              # (n_envs, obs_dim)
    bank: tuple                    # (bank_states, bank_obs)
    generator: torch.Generator     # on the env's device
    iteration: int


def _adam_tensors(opt: torch.optim.Adam, params):
    """Every tensor of Adam's state for `params`, created as Adam's first
    step would create them if it has not run yet."""
    out = []
    on_device = opt.defaults["capturable"]
    for p in params:
        st = opt.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32,
                                     device=p.device if on_device else "cpu")
            st["exp_avg"] = torch.zeros_like(p)
            st["exp_avg_sq"] = torch.zeros_like(p)
        out += [st["step"], st["exp_avg"], st["exp_avg_sq"]]
    return out


class PPOTrainer:
    def __init__(self, env, config: PPOConfig = PPOConfig(), demo=None):
        """`demo` (optional demo rows (T, row_dim)): build the reset bank with
        reference-state initialisation (rollout.make_rsi_bank)."""
        self.env = env
        self.config = config
        self.demo = None if demo is None else torch.as_tensor(
            demo, dtype=torch.float32, device=env.device)
        self.anchor_net = None   # set_anchor(): see PPOConfig.anchor_coef
        self.bc_anchor = None    # set_bc_anchor(): see PPOConfig.bc_coef

    def make_net(self, seed: int) -> MLPPolicy:
        """A freshly initialised network on the env's device."""
        gen = torch.Generator().manual_seed(seed)
        return MLPPolicy(self.env.obs_dim, self.env.action_dim, self.config.hidden,
                         generator=gen).to(self.env.device)

    def _optimizer(self, net) -> torch.optim.Adam:
        return torch.optim.Adam(net.parameters(), lr=self.config.lr, eps=1e-8,
                                capturable=self.env.device.type == "cuda")

    def set_anchor(self, net: MLPPolicy):
        """Fix the anchor policy for PPOConfig.anchor_coef > 0 (typically
        the cloned initialiser): a frozen copy of `net`."""
        self.anchor_net = copy.deepcopy(net).requires_grad_(False)

    def set_bc_anchor(self, obs_n, actions):
        """Fix the demo dataset for PPOConfig.bc_coef > 0: obs already
        normalised with the stage's (frozen) statistics."""
        dev = self.env.device
        self.bc_anchor = (torch.as_tensor(obs_n, dtype=torch.float32, device=dev),
                          torch.as_tensor(actions, dtype=torch.float32, device=dev))

    def init(self, generator: torch.Generator, net: MLPPolicy | None = None) -> PPOState:
        """A fresh trainer state. The network is `net`, or one initialised
        from the generator's seed; the bank and the first lanes are drawn
        from the generator."""
        cfg, dev = self.config, self.env.device
        if net is None:
            net = self.make_net(generator.initial_seed())
        if self.demo is not None:
            bank = ro.make_rsi_bank(self.env, self.demo, generator, cfg.reset_bank_size)
        else:
            bank = ro.make_reset_bank(self.env, generator, cfg.reset_bank_size)
        idx = torch.randint(0, cfg.reset_bank_size, (cfg.n_envs,), generator=generator,
                            device=dev)
        env_states, obs = take(bank, idx)
        return PPOState(net=net, optimizer=self._optimizer(net),
                        obs_norm=vnorm.RunningNorm.create(self.env.obs_dim, dev),
                        env_states=env_states, obs=obs, bank=bank, generator=generator,
                        iteration=0)

    def warm_start(self, ts: PPOState, src_net: MLPPolicy, src_obs_norm, seed: int = 0,
                   reset_value: bool = True, log_std: float | None = None) -> PPOState:
        """Stage-transition warm start (imitation -> fine-tune): copy the
        actor tower (and the running statistics) from the source stage, but
        initialise the critic afresh: the source critic is fitted to another
        reward scale, and its value error would otherwise dominate the shared
        update. `log_std` optionally re-opens exploration. The optimiser
        state starts fresh."""
        net = self.make_net(seed)
        sd = net.state_dict()
        for k, v in src_net.state_dict().items():
            if not (reset_value and k.startswith("vf_")):
                sd[k] = v.detach().clone()
        if log_std is not None:
            sd["log_std"] = torch.full_like(sd["log_std"], log_std)
        net.load_state_dict(sd)
        return dataclasses.replace(ts, net=net, optimizer=self._optimizer(net),
                                   obs_norm=src_obs_norm)

    def _action_fn(self, net, obs_norm):
        rho = self.config.noise_rho

        def fn(obs, nu, eps_prev):
            mean, log_std, value = net(vnorm.normalize(obs_norm, obs))
            eps = rho * eps_prev + math.sqrt(1.0 - rho * rho) * nu
            # the unclipped sample is stored; the rollout clips what the env
            # executes. A logp at the clipped action would reward pushing the
            # mean outward.
            a = mean + torch.exp(log_std) * eps
            return a, gaussian_logp(a, mean, log_std), value, eps
        return fn

    def _gae(self, traj, last_value):
        cfg = self.config
        rewards, values, dones = traj["reward"], traj["value"], traj["done"]
        values_tp1 = torch.cat([values[1:], last_value[None]], dim=0)
        not_done = 1.0 - dones.to(torch.float32)
        deltas = rewards + cfg.gamma * values_tp1 * not_done - values
        adv, advs = torch.zeros_like(last_value), []
        for t in reversed(range(rewards.shape[0])):
            adv = deltas[t] + cfg.gamma * cfg.gae_lambda * not_done[t] * adv
            advs.append(adv)
        advs = torch.stack(advs[::-1])
        return advs, advs + values

    def _loss(self, net, batch):
        cfg = self.config
        mean, log_std, value = net(batch["obs_n"])
        logp = gaussian_logp(batch["action"], mean, log_std)
        logratio = logp - batch["logp"]
        ratio = torch.exp(logratio)
        # policy-gradient and KL terms count only the steps where the
        # policy's action was executed; all-ones for plain envs
        m = batch["pg_mask"].to(torch.float32)
        msum = torch.clamp_min(m.sum(), 1.0)
        adv = batch["adv"]
        a_mean = (adv * m).sum() / msum
        a_std = torch.sqrt(torch.clamp_min(((adv - a_mean) ** 2 * m).sum() / msum, 0.0))
        adv = (adv - a_mean) / (a_std + 1e-8)
        pg = -(torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv) * m).sum() / msum
        vf = 0.5 * ((value - batch["ret"]) ** 2).mean()
        ent = (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum()
        # the non-negative KL estimator (Schulman's k3)
        kl_est = ((ratio - 1.0 - logratio) * m).sum() / msum
        pg_coef = 0.0 if cfg.freeze_actor else 1.0
        anchor = torch.zeros((), device=mean.device)
        if cfg.anchor_coef > 0.0 and self.anchor_net is not None:
            anchor = ((mean - self.anchor_net(batch["obs_n"])[0]) ** 2).mean()
        bc_mse = torch.zeros((), device=mean.device)
        if cfg.bc_coef > 0.0 and self.bc_anchor is not None:
            bo, ba = self.bc_anchor
            bc_mse = ((net(bo)[0] - ba) ** 2).mean()
        loss = (pg_coef * (pg - cfg.ent_coef * ent) + cfg.vf_coef * vf
                + cfg.anchor_coef * anchor + cfg.bc_coef * bc_mse)
        return loss, {"pg_loss": pg, "vf_loss": vf, "anchor_mse": anchor, "bc_mse": bc_mse,
                      "approx_kl": (-logratio * m).sum() / msum, "kl_est": kl_est}

    def _minibatch_update(self, ts: PPOState, sl: dict, halted):
        """One clipped Adam step on a minibatch. With kl_stop, the step is
        taken and then undone (parameters, Adam's moments and its step count)
        where `halted`, a 0-d bool on the device, holds after this
        minibatch's KL estimate: a masked update, with no read on the host."""
        cfg, net, opt = self.config, ts.net, ts.optimizer
        # the step size is the trainer's, the moments the state's: a critic
        # warm-up trainer (its own lr) and the stage's trainer share a state,
        # as optax's transforms share an opt_state in the JAX package
        for group in opt.param_groups:
            group["lr"] = cfg.lr
        loss, aux = self._loss(net, sl)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for p in net.parameters() if p.grad is not None]
        torch.nn.utils.clip_grad_norm_(params, cfg.max_grad_norm)
        if cfg.kl_stop > 0.0:
            halted = halted | (aux["kl_est"].detach() > cfg.kl_stop)
            live = [p.data for p in params] + _adam_tensors(opt, params)
            before = [t.clone() for t in live]
        opt.step()
        if cfg.kl_stop > 0.0:
            for t, old in zip(live, before):
                t.copy_(torch.where(halted.to(t.device), old, t))
        return halted, loss.detach(), {k: v.detach() for k, v in aux.items()}

    def train_step(self, ts: PPOState, noise=None, reset_idx=None, perms=None):
        """One learner iteration: a segment rollout, GAE, n_epochs of
        minibatch updates. Updates ts.net and ts.optimizer in place; returns
        (new state, metrics of 0-d tensors). `noise` (T, N, A), `reset_idx`
        (T, N) and `perms` (n_epochs, T·N) replace the generator's draws."""
        cfg, gen, env = self.config, ts.generator, self.env
        net = ts.net
        with torch.no_grad():
            env_states, obs, traj = ro.segment_rollout(
                env, self._action_fn(net, ts.obs_norm), ts.env_states, ts.obs, ts.bank,
                gen, cfg.segment_len, noise=noise, reset_idx=reset_idx)
            obs_norm = ts.obs_norm if cfg.freeze_obs_norm else vnorm.update(
                ts.obs_norm, traj["obs"].reshape(-1, env.obs_dim))
            # the batch is normalised with the statistics the rollout used
            last_value = net(vnorm.normalize(ts.obs_norm, obs))[2]
            advs, rets = self._gae(traj, last_value)
            batch = {
                "obs_n": vnorm.normalize(ts.obs_norm, traj["obs"]).reshape(-1, env.obs_dim),
                "action": traj["action"].reshape(-1, env.action_dim),
                "logp": traj["logp"].reshape(-1), "adv": advs.reshape(-1),
                "ret": rets.reshape(-1), "pg_mask": traj["pg_mask"].reshape(-1)}
        n = batch["logp"].shape[0]
        mb = n // cfg.n_minibatches
        halted = torch.zeros((), dtype=torch.bool, device=env.device)
        losses, auxs = [], []
        for e in range(cfg.n_epochs):
            perm = (torch.randperm(n, generator=gen, device=env.device)
                    if perms is None else perms[e])
            for i in range(cfg.n_minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                halted, loss, aux = self._minibatch_update(
                    ts, {k: v[idx] for k, v in batch.items()}, halted)
                losses.append(loss)
                auxs.append(aux)
        metrics = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        metrics.update(loss=torch.stack(losses).mean(), mean_reward=traj["reward"].mean(),
                       episode_rate=traj["done"].to(torch.float32).mean())
        return dataclasses.replace(ts, obs_norm=obs_norm, env_states=env_states, obs=obs,
                                   iteration=ts.iteration + 1), metrics

    @torch.no_grad()
    def evaluate(self, ts: PPOState, n_episodes: int = 8, max_steps: int = 200,
                 generator: torch.Generator | None = None):
        """Deterministic episodes (the clipped mean action) on fresh
        scenarios, from a generator of its own unless one is given."""
        if generator is None:
            generator = torch.Generator(self.env.device).manual_seed(321 + ts.iteration)
        states, obs = ro.make_reset_bank(self.env, generator, n_episodes)

        def policy(o):
            return torch.clamp(ts.net(vnorm.normalize(ts.obs_norm, o))[0], -1.0, 1.0)

        rets, info = ro.episode_returns(self.env, policy, states, obs, max_steps, generator)
        return {"return_mean": rets.mean(), "return_std": rets.std(unbiased=False),
                "max_height": info["max_height"].max(), "max_fwd": info["max_fwd"].max()}
