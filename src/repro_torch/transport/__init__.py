"""Port of ``repro.transport``: the split step over bare codecs (``split``)."""
from repro_torch.transport.split import (apply_codec, make_split_loss_fn,
                                         make_split_train_step, masked_decode,
                                         roundtrip, split_comm_bytes,
                                         split_value_and_grad)

__all__ = ["apply_codec", "make_split_loss_fn", "make_split_train_step",
           "masked_decode", "roundtrip", "split_comm_bytes",
           "split_value_and_grad"]
