"""Models of the port: the DLRM part of ``repro.models.recsys`` (dot
interaction, through the hand-written kernel).  The other side models are
the next item of ROADMAP.md §1."""
from repro_torch.models import recsys  # noqa: F401
