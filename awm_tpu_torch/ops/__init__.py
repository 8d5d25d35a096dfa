from awm_tpu_torch.ops.conv import conv1d, conv_transpose1d
from awm_tpu_torch.ops.lstm import lstm_cell, lstm_forward, lstm_stack
from awm_tpu_torch.ops.lstm_kernel import lstm_fused_forward

__all__ = ["conv1d", "conv_transpose1d", "lstm_cell", "lstm_forward", "lstm_fused_forward", "lstm_stack"]
