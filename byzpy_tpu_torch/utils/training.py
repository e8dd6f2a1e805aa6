"""Training-loop helper.

Counterpart of ``byzpy_tpu/utils/training.py`` (API parity:
``byzpy/utils/training.py:7-34``): ``train_with_progress`` drives a
``ParameterServer`` (anything with a ``round()``, sync or async) for N
rounds with a periodic evaluation and returns the evaluation history. A
progress bar is drawn with tqdm where it is installed.
"""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, Callable, List, Optional, Tuple

EvalCallback = Callable[[int], Any]


async def train_with_progress_async(
    ps: Any,
    rounds: int,
    *,
    eval_callback: Optional[EvalCallback] = None,
    eval_interval: int = 10,
    progress: bool = True,
) -> List[Tuple[int, Any]]:
    """Run ``rounds`` rounds of ``ps.round()``, calling
    ``eval_callback(i)`` every ``eval_interval`` rounds and after the last;
    returns ``[(round_index, eval_result), ...]``."""
    bar = None
    if progress:
        try:
            from tqdm import tqdm

            bar = tqdm(total=rounds, desc="training", leave=False)
        except ImportError:
            bar = None
    history: List[Tuple[int, Any]] = []
    try:
        for i in range(rounds):
            out = ps.round()
            if inspect.isawaitable(out):
                await out
            if eval_callback is not None and ((i + 1) % eval_interval == 0 or i == rounds - 1):
                result = eval_callback(i)
                if inspect.isawaitable(result):
                    result = await result
                history.append((i, result))
                if bar is not None and result is not None:
                    bar.set_postfix_str(str(result))
            if bar is not None:
                bar.update(1)
    finally:
        if bar is not None:
            bar.close()
    return history


def train_with_progress(
    ps: Any,
    rounds: int,
    *,
    eval_callback: Optional[EvalCallback] = None,
    eval_interval: int = 10,
    progress: bool = True,
) -> List[Tuple[int, Any]]:
    """The synchronous form: runs an event loop of its own."""
    return asyncio.run(train_with_progress_async(
        ps, rounds, eval_callback=eval_callback, eval_interval=eval_interval, progress=progress))


__all__ = ["train_with_progress", "train_with_progress_async"]
