"""Models of the port: DLRM (``recsys``, dot interaction, through the
hand-written kernel) and the decoder-only LM (``transformer`` over
``layers`` and ``moe``).  The other side models are the next items of
ROADMAP.md §1."""
from repro_torch.models import layers, moe, recsys, transformer  # noqa: F401
