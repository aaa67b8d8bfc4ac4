"""Tasks of the port: the loop bodies of the jobs (importing this package
registers them)."""

from thinkdiff_torch.tasks import base_task, image_text_process_data  # noqa: F401
from thinkdiff_torch.tasks.base_task import setup_task  # noqa: F401
