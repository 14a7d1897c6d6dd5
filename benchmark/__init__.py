"""The benchmark of the PyTorch / CUDA port (``neuralrecon_w_tpu_torch``) on
the H100: ``python benchmark/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the checkout's root. It imports nothing of JAX
or of the JAX package."""
