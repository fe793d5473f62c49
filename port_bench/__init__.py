"""The benchmark of the PyTorch/CUDA port (``feature_point_cnn_tpu_torch``)
on one NVIDIA H100; ``run.py`` runs one cell once."""
