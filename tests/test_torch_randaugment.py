"""Port parity: RandAugment (``thinkdiff_torch/data/randaugment.py``)
against the JAX package's module on the CPU: each of the 14 operations at
several magnitudes, the level-to-argument maps, and ``RandomAugment`` under
one seed (``np.random``'s state and an explicit ``RandomState``), all
identical to the uint8."""

import numpy as np
import pytest
from PIL import Image

from thinkdiff_torch.data import randaugment as tra
from thinkdiff_tpu.data import randaugment as jra


@pytest.fixture
def img():
    rs = np.random.RandomState(0)
    base = np.linspace(0, 200, 24 * 30).reshape(24, 30, 1)
    noise = rs.randint(0, 55, (24, 30, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def test_surface_is_jax_s():
    assert list(tra.OPS) == list(jra.OPS)
    assert (tra.MAX_LEVEL, tra.TRANSLATE_CONST, tra.REPLACE_VALUE) == \
        (jra.MAX_LEVEL, jra.TRANSLATE_CONST, jra.REPLACE_VALUE)


@pytest.mark.parametrize("name", list(jra.OPS))
def test_each_op_identical_at_every_level(img, name):
    fn_t, args_t = tra.OPS[name]
    fn_j, args_j = jra.OPS[name]
    for level in (0, 3, 7, 10):
        for seed in (0, 1):
            a = args_t(level, np.random.RandomState(seed))
            b = args_j(level, np.random.RandomState(seed))
            assert a == b, (name, level)
            np.testing.assert_array_equal(fn_t(img, *a), fn_j(img, *b),
                                          err_msg=f"{name}@{level}")


def test_cutout_identical(img):
    a = tra.cutout(img, 5, (1, 2, 3), rng=np.random.RandomState(4))
    b = jra.cutout(img, 5, (1, 2, 3), rng=np.random.RandomState(4))
    np.testing.assert_array_equal(a, b)


def test_random_augment_identical_under_one_seed(img):
    for n, m in ((2, 10), (3, 5), (1, 9)):
        np.random.seed(7)
        got = [tra.RandomAugment(n, m)(img) for _ in range(6)]
        np.random.seed(7)
        want = [jra.RandomAugment(n, m)(img) for _ in range(6)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    augs = ["Rotate", "Equalize", "ShearY"]
    got = tra.RandomAugment(2, 8, isPIL=True, augs=augs,
                            rng=np.random.RandomState(3))
    want = jra.RandomAugment(2, 8, isPIL=True, augs=augs,
                             rng=np.random.RandomState(3))
    for _ in range(5):
        np.testing.assert_array_equal(got(Image.fromarray(img)),
                                      want(Image.fromarray(img)))
    with pytest.raises(KeyError, match="Unknown augmentation"):
        tra.RandomAugment(augs=["Nope"])
