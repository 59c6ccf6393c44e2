"""Models of the port: the recommenders (``recsys``: DeepFM, DLRM through
the hand-written dot-interaction kernel, SASRec and BERT4Rec), GIN
(``gnn``) and the decoder-only LM (``transformer`` over ``layers`` and
``moe``), forward only."""
from repro_torch.models import gnn, layers, moe, recsys, transformer  # noqa: F401
