"""Models: the decoder LM (``lm``: every family of ``configs``, on the
layers of ``layers``, ``ssm`` and ``moe``), the MoE layer on the
load-balanced segmented GEMM, and the TreeLSTM."""
