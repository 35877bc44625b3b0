"""Models on the load-balanced kernels: the MoE layer and the TreeLSTM."""
