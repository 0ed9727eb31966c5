"""Scripts that measure the port on a CUDA card (run from the checkout's
root with ``python3 -m paddle_tpu_torch.tools.<name>``)."""
