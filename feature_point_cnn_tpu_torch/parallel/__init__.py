"""Data parallelism over ranks of a `torch.distributed` job
(`feature_point_cnn_tpu/parallel/`): the launch layer (`distributed`), the
data mesh (`mesh`) and the two sums every data-parallel module calls
(`collectives`)."""
