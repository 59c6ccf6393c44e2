"""Models of the port: the DLRM part of ``repro.models.recsys`` (dot
interaction, through the hand-written kernel).  The other side models are
ROADMAP.md §1 item 8."""
from repro_torch.models import recsys  # noqa: F401
