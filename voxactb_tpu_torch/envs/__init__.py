"""Environment adapters: the bimanual env contract, fake env for tests, RLBench bridge."""

from voxactb_tpu_torch.envs.base import BimanualEnv, Transition  # noqa: F401
