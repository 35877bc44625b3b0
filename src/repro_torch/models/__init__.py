"""Models: the decoder LM (``lm``: every family of ``configs``, on the
layers of ``layers``, ``ssm`` and ``moe``), the MoE layer on the
load-balanced segmented GEMM, and the TreeLSTM."""
from repro_torch.models.lm import (active_param_count, cache_shape,
                                   decode_step, forward, init_cache,
                                   init_params, lm_loss, param_count,
                                   param_shapes)
from repro_torch.models.frontends import (frontend_embed_shape,
                                          make_frontend_embeds)
from repro_torch.models.treelstm import (init_treelstm, tree_roots,
                                         treelstm_embed, treelstm_forest)

__all__ = ["active_param_count", "cache_shape", "decode_step", "forward",
           "init_cache", "init_params", "lm_loss", "param_count",
           "param_shapes", "frontend_embed_shape", "make_frontend_embeds",
           "init_treelstm", "tree_roots", "treelstm_embed",
           "treelstm_forest"]
