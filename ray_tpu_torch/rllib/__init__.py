"""ray_tpu_torch.rllib — RL training: CPU env-runner actors + learners on
leased CUDA cards.

The port of ``ray_tpu/rllib`` (reference: rllib/, SURVEY.md §2.3 — the
new-stack slice: EnvRunnerGroup, LearnerGroup, PPO and the algorithms
beside it). Env runners are CPU actors stepping numpy environments with a
numpy copy of the policy, and never import torch; each learner holds its
module and optimizer on one device, a card leased with
``num_gpus_per_learner`` (default 1) or the CPU at 0; a ``LearnerGroup``
with ``mesh_devices`` d > 1 is d such learners, one process per card,
all-reducing their gradients over NCCL. Importing this
package loads no torch: a learner imports it when it is built.
"""

from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig, MARWIL, MARWILConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.multi_agent_ppo import (  # noqa: F401
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig  # noqa: F401
from ray_tpu_torch.rllib.env.multi_agent import (  # noqa: F401
    MultiAgentCartPole,
    MultiAgentEnv,
)
