"""Pipeline schedules (copied from ``deepspeed_tpu/runtime/pipe/schedule.py``;
reference ``runtime/pipe/schedule.py``).

The JAX package keeps these as its planning layer beside an SPMD scan.  The
port runs them: its executor (``executor.py``) drives each stage through
the instruction stream of ``TrainSchedule`` (1F1B) or ``GPipeSchedule``
(all forwards, then all backwards), as the reference's
``PipelineEngine._exec_schedule`` does (pipe/engine.py:1293).  API parity:
``PipeSchedule`` (:11), ``TrainSchedule`` (:189) with its step->microbatch
mapping (:258-298), ``InferenceSchedule`` (:135), instruction classes
(:327-487).  ``GPipeSchedule`` is the port's own.
"""
from __future__ import annotations

from typing import Iterator, List


class PipeInstruction:
    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        if self.kwargs:
            args = ", ".join(f"{k}={v}" for k, v in self.kwargs.items())
            return f"{self.name}({args})"
        return self.name

    def __eq__(self, other):
        return (type(self) is type(other)) and self.kwargs == other.kwargs

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.kwargs.items()))))


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class LoadMicroBatch(PipeInstruction):
    pass  # kwargs: buffer_id


class ForwardPass(PipeInstruction):
    pass  # kwargs: buffer_id


class BackwardPass(PipeInstruction):
    pass  # kwargs: buffer_id


class SendActivation(PipeInstruction):
    pass  # kwargs: buffer_id


class RecvActivation(PipeInstruction):
    pass  # kwargs: buffer_id


class SendGrad(PipeInstruction):
    pass  # kwargs: buffer_id


class RecvGrad(PipeInstruction):
    pass  # kwargs: buffer_id


class PipeSchedule:
    """Enumerates the instruction stream for one (stage, #microbatch) pair."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    def steps(self) -> Iterator[List[PipeInstruction]]:
        raise NotImplementedError

    @property
    def num_micro_batches(self) -> int:
        return self.micro_batches

    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.stages - 1

    def _valid_micro_batch(self, micro_batch_id: int) -> bool:
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id: int) -> bool:
        return 0 <= stage_id < self.stages

    def num_pipe_buffers(self) -> int:
        return self.micro_batches

    def __iter__(self):
        return iter(self.steps())


class InferenceSchedule(PipeSchedule):
    """Forward-only wavefront (reference :135)."""

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            micro_batch_id = step_id - self.stage_id
            cmds: List[PipeInstruction] = []
            if self._valid_micro_batch(micro_batch_id):
                if not self.is_first_stage:
                    cmds.append(RecvActivation(buffer_id=self._buffer_idx(micro_batch_id)))
                if self.is_first_stage or self.is_last_stage:
                    # first stage loads inputs; last stage loads labels
                    cmds.append(LoadMicroBatch(buffer_id=self._buffer_idx(micro_batch_id)))
                cmds.append(ForwardPass(buffer_id=self._buffer_idx(micro_batch_id)))
                if not self.is_last_stage:
                    cmds.append(SendActivation(buffer_id=self._buffer_idx(micro_batch_id)))
            yield cmds

    def num_pipe_buffers(self) -> int:
        return 2

    def _buffer_idx(self, micro_batch_id: int) -> int:
        return micro_batch_id % self.num_pipe_buffers()


class TrainSchedule(PipeSchedule):
    """Synchronous 1F1B on a global wavefront clock.

    Derivation (original, replaces the reference's four parity-case helpers
    with one closed form).  Put all S stages on one shared clock where every
    tick is either a forward slot or a backward slot for a given stage:

    * Forward of microbatch ``m`` enters stage 0 at tick ``2m`` and ripples
      down one stage per tick, so on stage ``s`` it fires at

          t_fwd(m, s) = s + 2m

    * The loss for microbatch ``m`` is ready when the last stage finishes its
      forward, and the backward wave ripples back *up* one stage per tick:

          t_bwd(m, s) = (2S - 1 - s) + 2m

      (on the last stage this is t_fwd + 1: backward immediately follows
      forward — the 1F1B steady state).

    Because ``t_fwd - s`` is even and ``t_bwd + s`` is odd, each tick is
    unambiguously a forward or a backward slot for a stage — stage ``s`` runs
    forwards on ticks with the same parity as ``s`` and backwards on the
    opposite parity, alternating 1F/1B once full.  The last backward
    (m = M-1, s = 0) lands on tick 2(M + S - 1) - 1, giving the familiar
    2(M + S - 1) total ticks.

    Activation-stash bound: forward ``m + B`` on stage ``s`` overwrites
    buffer ``m % B``; safety requires t_bwd(m, s) < t_fwd(m + B, s), i.e.
    B >= S - s — deeper stages retire activations sooner, so the stash
    shrinks linearly toward the last stage.
    """

    def steps(self):
        prev_micro_batch_id = -1
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        for step_id in range(total_steps):
            micro_batch_id, is_forward = self._work_at_tick(step_id)
            cmds: List[PipeInstruction] = []

            # Ship the previous tick's product to the neighbor that needs it
            # this tick: a finished forward feeds the next stage, a finished
            # backward feeds grads to the previous stage.
            if self._valid_micro_batch(prev_micro_batch_id):
                if is_forward:
                    if self._valid_stage(self.prev_stage):
                        cmds.append(SendGrad(buffer_id=self._buffer_idx(prev_micro_batch_id)))
                else:
                    if self._valid_stage(self.next_stage):
                        cmds.append(SendActivation(buffer_id=self._buffer_idx(prev_micro_batch_id)))
            if self._valid_micro_batch(micro_batch_id):
                buf = self._buffer_idx(micro_batch_id)
                if is_forward:
                    if self._valid_stage(self.prev_stage):
                        cmds.append(RecvActivation(buffer_id=buf))
                    if self.is_first_stage or self.is_last_stage:
                        # First stage loads inputs; last stage loads labels.
                        cmds.append(LoadMicroBatch(buffer_id=buf))
                    cmds.append(ForwardPass(buffer_id=buf))
                else:
                    if self._valid_stage(self.next_stage):
                        cmds.append(RecvGrad(buffer_id=buf))
                    cmds.append(BackwardPass(buffer_id=buf))

            # final tick: reduce + step
            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            prev_micro_batch_id = micro_batch_id
            yield cmds

    def _work_at_tick(self, tick: int):
        """Invert the wavefront formulas: which (microbatch, phase) does this
        stage run at ``tick``?  The returned microbatch may be out of range
        (fill/drain bubbles); callers filter with ``_valid_micro_batch``."""
        if (tick - self.stage_id) % 2 == 0:
            return (tick - self.stage_id) // 2, True
        return (tick - (2 * self.stages - 1 - self.stage_id)) // 2, False

    def num_pipe_buffers(self) -> int:
        # B >= S - s from the stash bound above; >=2 for send/compute overlap.
        return max(2, min(self.stages - self.stage_id, self.micro_batches))

    def _buffer_idx(self, micro_batch_id: int) -> int:
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()


class GPipeSchedule(PipeSchedule):
    """GPipe fill/drain on the same clock and instructions: every forward
    wave first (microbatch ``m`` on stage ``s`` at tick ``s + m``), then the
    backward wave from the last stage (at tick ``(M + S - 1) + (S - 1 - s)
    + m``).  Each tick ships the previous tick's product, as
    :class:`TrainSchedule` does; every activation stays stashed until its
    backward, so the stash grows with M (the reference's 1F1B bounds it by
    ``S - s``)."""

    def steps(self):
        fill = self.micro_batches + self.stages - 1
        prev = (-1, True)
        for step_id in range(2 * fill):
            if step_id < fill:
                work = (step_id - self.stage_id, True)
            else:
                work = (step_id - fill - (self.stages - 1 - self.stage_id), False)
            cmds: List[PipeInstruction] = []
            if self._valid_micro_batch(prev[0]):
                if prev[1] and self._valid_stage(self.next_stage):
                    cmds.append(SendActivation(buffer_id=self._buffer_idx(prev[0])))
                elif not prev[1] and self._valid_stage(self.prev_stage):
                    cmds.append(SendGrad(buffer_id=self._buffer_idx(prev[0])))
            micro_batch_id, is_forward = work
            if self._valid_micro_batch(micro_batch_id):
                buf = self._buffer_idx(micro_batch_id)
                if is_forward:
                    if self._valid_stage(self.prev_stage):
                        cmds.append(RecvActivation(buffer_id=buf))
                    if self.is_first_stage or self.is_last_stage:
                        cmds.append(LoadMicroBatch(buffer_id=buf))
                    cmds.append(ForwardPass(buffer_id=buf))
                else:
                    if self._valid_stage(self.next_stage):
                        cmds.append(RecvGrad(buffer_id=buf))
                    cmds.append(BackwardPass(buffer_id=buf))
            if step_id == 2 * fill - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())
            prev = work
            yield cmds

    def _buffer_idx(self, micro_batch_id: int) -> int:
        return micro_batch_id
