"""Host-side native code: the threaded batch loader (`csrc/batch_loader.cc`)."""

from equiadapt_tpu_torch.native.loader import (
    NativeBatchLoader,
    native_available,
    write_record_file,
)

__all__ = ["NativeBatchLoader", "native_available", "write_record_file"]
