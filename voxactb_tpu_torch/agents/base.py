"""The Agent contract shared by training runners and rollout generators.

A copy of ``voxactb_tpu.agents.base`` (YARR's ``Agent`` ABC and the
``ActResult``/``Summary`` hierarchy, YARR/yarr/agents/agent.py:5-78), kept in
the port so it imports nothing of the JAX package.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class Summary:
    name: str
    value: Any


@dataclass
class ScalarSummary(Summary):
    pass


@dataclass
class HistogramSummary(Summary):
    pass


@dataclass
class ImageSummary(Summary):
    pass


@dataclass
class TextSummary(Summary):
    pass


@dataclass
class VideoSummary(Summary):
    fps: int = 30


@dataclass
class ActResult:
    """Action + elements to stash in observation history + replay + info."""

    action: Any
    observation_elements: Dict[str, Any] = field(default_factory=dict)
    replay_elements: Dict[str, Any] = field(default_factory=dict)
    info: Dict[str, Any] = field(default_factory=dict)


class Agent(abc.ABC):
    """build/update/act + summaries + weight IO (yarr/agents/agent.py:45-78)."""

    @abc.abstractmethod
    def build(self, training: bool, device=None) -> None:
        ...

    @abc.abstractmethod
    def update(self, step: int, replay_sample: dict) -> dict:
        ...

    @abc.abstractmethod
    def act(self, step: int, observation: dict, deterministic: bool = False,
            **kwargs) -> ActResult:
        ...

    def reset(self) -> None:
        pass

    def update_summaries(self) -> List[Summary]:
        return []

    def act_summaries(self) -> List[Summary]:
        return []

    @abc.abstractmethod
    def load_weights(self, savedir: str) -> None:
        ...

    @abc.abstractmethod
    def save_weights(self, savedir: str) -> None:
        ...
