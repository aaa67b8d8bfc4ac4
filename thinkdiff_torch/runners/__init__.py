"""Runners of the port: the job drivers (importing this package registers
them)."""

from thinkdiff_torch.runners import runner_base, runner_process_data  # noqa: F401
