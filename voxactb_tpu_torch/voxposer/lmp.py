"""Language Model Programs: prompt assembly, cached LLM calls, sandboxed execution.

Counterpart of peract/voxposer/LMP.py:12-214 and LLM_cache.py:6-65. Redesign points:
- the LLM transport is a pluggable ``LLMBackend`` protocol instead of a hardwired
  openai client — ``ScriptedBackend`` (canned code keyed by query substring, for tests
  and offline runs), ``CallableBackend`` (any ``prompt -> code`` function, e.g. a real
  API client), both behind a content-addressed ``DiskCache``;
- the exec sandbox keeps the reference's policy (no ``import``, no dunder access,
  neutered exec/eval) with a restricted builtins table.

Query canonicalization for the four bimanual tasks (LMP.py:31-47) is preserved, as it
is part of the method's behavior on those tasks.

A copy of ``voxactb_tpu.voxposer.lmp``, kept in the port so that it imports nothing
of the JAX package; host code, the same on every device.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Protocol

# the default LLM cache, under the process's temp directory (``$TMPDIR``)
DEFAULT_CACHE_DIR = os.path.join(tempfile.gettempdir(), "voxactb_llm_cache")

# bimanual task queries are rewritten to planner-friendly phrasings (LMP.py:31-47)
QUERY_REWRITES = [
    (
        lambda q: q.startswith("grasp the jar with left hand"),
        lambda q: q.split("right hand")[0] + "right hand",
    ),
    (
        lambda q: q.startswith("grasp the jar with right hand"),
        lambda q: q.split("left hand")[0] + "left hand",
    ),
    (
        lambda q: q == "hold the drawer with left hand and open the bottom drawer with right hand",
        lambda q: "get close to the top drawer with left hand and get close to the bottom drawer with right hand",
    ),
    (
        lambda q: q == "hold the drawer with right hand and open the bottom drawer with left hand",
        lambda q: "get close to the top drawer with right hand and get close to the bottom drawer with left hand",
    ),
    (
        lambda q: q == "open the top drawer with right hand and put the item in the top drawer with left hand",
        lambda q: "get close to the top drawer handle with right hand and get close to the item with left hand",
    ),
    (
        lambda q: q == "open the top drawer with left hand and put the item in the top drawer with right hand",
        lambda q: "get close to the top drawer handle with left hand and get close to the item with right hand",
    ),
]


class DiskCache:
    """Pickle cache keyed by a stable hash of the call kwargs (LLM_cache.py:6-65)."""

    def __init__(self, cache_dir: str, load_cache: bool = True):
        self._dir = cache_dir
        self._enabled = load_cache
        os.makedirs(cache_dir, exist_ok=True)

    def _path(self, key: dict) -> str:
        digest = hashlib.sha256(
            json.dumps(key, sort_keys=True, default=str).encode()).hexdigest()[:32]
        return os.path.join(self._dir, f"{digest}.pkl")

    def get(self, key: dict):
        p = self._path(key)
        if self._enabled and os.path.exists(p):
            with open(p, "rb") as f:
                return pickle.load(f)
        return None

    def put(self, key: dict, value) -> None:
        with open(self._path(key), "wb") as f:
            pickle.dump(value, f)


class LLMBackend(Protocol):
    def __call__(self, prompt: str, stop: list) -> str:
        """Full prompt -> generated code."""


class ScriptedBackend:
    """Deterministic canned programs keyed by substring match — offline/test LLM."""

    def __init__(self, programs: Dict[str, str], default: str = "pass"):
        self._programs = programs
        self._default = default

    def __call__(self, prompt: str, stop: list) -> str:
        query = prompt.rsplit("# Query:", 1)[-1].strip()
        for needle, code in self._programs.items():
            if needle in query:
                return code
        return self._default


class CallableBackend:
    def __init__(self, fn: Callable[[str], str]):
        self._fn = fn

    def __call__(self, prompt: str, stop: list) -> str:
        return self._fn(prompt)


@dataclass
class LMPConfig:
    prompt_text: str = ""        # few-shot examples (the reference loads txt files)
    query_prefix: str = "# Query:"
    query_suffix: str = "."
    stop: list = field(default_factory=lambda: ["# Query:"])
    maintain_session: bool = False
    include_context: bool = True
    return_val_name: str = "ret_val"
    load_cache: bool = True


def merge_dicts(dicts):
    return {k: v for d in dicts for k, v in d.items()}


_SAFE_BUILTINS = {
    k: __builtins__[k] if isinstance(__builtins__, dict) else getattr(__builtins__, k)
    for k in ("range", "len", "enumerate", "zip", "min", "max", "abs", "sum",
              "float", "int", "str", "list", "dict", "tuple", "set", "print",
              "sorted", "reversed", "round", "isinstance", "True", "False", "None")
    if (k in __builtins__ if isinstance(__builtins__, dict) else hasattr(__builtins__, k))
}


def exec_safe(code_str: str, gvars: Optional[dict] = None,
              lvars: Optional[dict] = None) -> dict:
    """Execute generated code under the reference's sandbox policy (LMP.py:197-214)."""
    for banned in ("import", "__"):
        if banned in code_str:
            raise ValueError(f"banned phrase {banned!r} in generated code")
    gvars = dict(gvars or {})
    lvars = dict(lvars or {})
    noop = lambda *a, **k: None  # noqa: E731
    gvars = merge_dicts([
        gvars,
        {"exec": noop, "eval": noop, "open": noop,
         "__builtins__": dict(_SAFE_BUILTINS)},
    ])
    exec(code_str, gvars, lvars)  # noqa: S102 — sandboxed by construction above
    return lvars


class LMP:
    """One language-model program (planner / composer / UI layer in the LMP stack)."""

    def __init__(self, name: str, cfg: LMPConfig, backend: LLMBackend,
                 fixed_vars: Optional[dict] = None,
                 variable_vars: Optional[dict] = None,
                 cache_dir: str = DEFAULT_CACHE_DIR):
        self._name = name
        self._cfg = cfg
        self._backend = backend
        self._fixed_vars = fixed_vars or {}
        self._variable_vars = variable_vars or {}
        self._cache = DiskCache(cache_dir, cfg.load_cache)
        self.exec_hist = ""
        self._context: Optional[str] = None

    def clear_exec_hist(self):
        self.exec_hist = ""

    def set_context(self, context: str):
        self._context = context

    def canonicalize_query(self, query: str) -> str:
        for match, rewrite in QUERY_REWRITES:
            if match(query):
                return rewrite(query)
        return query

    def build_prompt(self, query: str):
        query = self.canonicalize_query(query)
        imports = (f"from utils import {', '.join(self._variable_vars)}"
                   if self._variable_vars else "")
        prompt = self._cfg.prompt_text.replace("{variable_vars_imports}", imports)
        if self._cfg.maintain_session and self.exec_hist:
            prompt += f"\n{self.exec_hist}"
        prompt += "\n"
        if self._cfg.include_context and self._context:
            prompt += f"\n{self._context}"
        user_query = f"{self._cfg.query_prefix}{query}{self._cfg.query_suffix}"
        prompt += f"\n{user_query}"
        return prompt, user_query

    def __call__(self, query: str, **extra_vars):
        prompt, user_query = self.build_prompt(query)
        key = {"name": self._name, "prompt": prompt, "stop": self._cfg.stop}
        code = self._cache.get(key)
        if code is None:
            code = self._backend(prompt, self._cfg.stop)
            # strip markdown fences only — the reference's blanket
            # .replace('python', '') (LMP.py:107) also corrupts occurrences
            # INSIDE the program (e.g. detect('python toy')) and caches the
            # damage; limit the strip to a fence-attached language tag
            code = re.sub(r"```(?:python)?", "", code).strip()
            self._cache.put(key, code)

        gvars = merge_dicts([self._fixed_vars, self._variable_vars, extra_vars])
        lvars = exec_safe(code, gvars)
        self.exec_hist += f"\n{user_query}\n{code}"
        return lvars.get(self._cfg.return_val_name)
