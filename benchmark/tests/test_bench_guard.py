"""The import check compares whole top-level names."""

from benchmark.guard import forbidden_loaded


def test_jax_package_is_refused_the_port_is_not():
    assert forbidden_loaded(["tacotron2_tpu"]) == ["tacotron2_tpu"]
    assert forbidden_loaded(["tacotron2_tpu.models.tacotron2"]) == [
        "tacotron2_tpu"]
    assert forbidden_loaded(["tacotron2_tpu_torch",
                             "tacotron2_tpu_torch.serve"]) == []


def test_jax_by_whole_name():
    assert forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
    assert forbidden_loaded(["jaxtyping", "flaxy", "numpy"]) == []
