from ahsoka_tpu_torch.emit.bubbleinfo import (  # noqa: F401
    write_bubbleinfo,
    write_bubbleinfo_file,
)
