"""The port's schedule tables against the JAX package's make_schedule."""
import dataclasses

import numpy as np
import pytest
import torch

from hicdiff_tpu.diffusion.schedules import make_schedule as jax_make_schedule
from hicdiff_tpu_torch.diffusion.schedules import make_schedule


@pytest.mark.parametrize("name", ["sigmoid", "linear", "cosine"])
def test_schedule_tables_bit_equal(name):
    """Every table, the fp32 sigmoid quirk included, is bit-equal at T=1000."""
    want = jax_make_schedule(name, 1000)
    got = make_schedule(name, 1000, device="cpu")
    assert got.num_timesteps == 1000
    for field in dataclasses.fields(got):
        table = getattr(got, field.name)
        assert table.dtype == torch.float32 and table.device.type == "cpu"
        np.testing.assert_array_equal(
            table.numpy(), np.asarray(getattr(want, field.name)), err_msg=field.name
        )


def test_schedule_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown beta schedule"):
        make_schedule("quadratic", 10, device="cpu")
