"""
Parameter schedules (learning rate, entropy and value-loss coefficients).

The port's counterpart of ``warpdrive_tpu/training/param_scheduler.py``: a
constant or a piecewise-linear-in-timestep schedule, evaluated on the host:
:meth:`get_param_value` in float64, :meth:`value_at` as the float32 value
the JAX update multiplies by.  A captured update reads its schedules from
0-dim device scalars, which :meth:`write_to` fills with that float32 value
before each iteration (a host value would be baked into the graph), and
counts as the tracer's ``scalar_writes`` while tracing is on.
"""

from __future__ import annotations

import numpy as np

from warpdrive_tpu_torch.core import trace


class ParamScheduler:
    """Constant or piecewise-linear schedule over the global env timestep."""

    def __init__(self, schedule):
        if isinstance(schedule, (int, float)):
            self.type = "constant"
            self._times = None
            self._values = None
        elif isinstance(schedule, (list, tuple)):
            self.type = "piecewise_linear"
            for item in schedule:
                assert (
                    isinstance(item, (list, tuple)) and len(item) == 2
                ), "each schedule entry must be [timestep, value]"
            times = [float(t) for t, _ in schedule]
            assert times == sorted(times), "schedule times must be increasing"
            self._times = np.asarray(times, dtype=np.float64)
            self._values = np.asarray([v for _, v in schedule], dtype=np.float64)
        else:
            raise NotImplementedError(f"unsupported schedule {schedule!r}")
        self.schedule = schedule

    def get_param_value(self, timestep) -> float:
        """Clamped linear interpolation, in float64."""
        assert timestep >= 0
        if self.type == "constant":
            return float(self.schedule)
        return float(np.interp(float(timestep), self._times, self._values))

    def value_at(self, timestep) -> np.float32:
        """The schedule's value as float32, the type the update uses."""
        if self.type == "constant":
            return np.float32(self.schedule)
        f32 = np.float32
        return f32(np.interp(f32(timestep), self._times.astype(f32),
                             self._values.astype(f32)))

    def write_to(self, scalar, timestep):
        """Fill the 0-dim float32 tensor ``scalar`` with
        :meth:`value_at` ``(timestep)``, bit for bit."""
        if trace.ON:
            trace.count_scalar_write()
        scalar.fill_(float(self.value_at(timestep)))
