"""The numpy + zlib PNG codec (utils/png.py): round trips for every
supported colour type and filter type, and the texture decode path."""

import numpy as np
import pytest

from raytracer2.utils.png import UnsupportedPNG, decode_png, encode_png


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_round_trip(channels, filter_type):
    rng = np.random.default_rng(channels * 10 + filter_type)
    img = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    img[:, :5] = 200  # flat runs next to noise exercise every predictor
    data = encode_png(img, filter_type=filter_type)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(data), img)


def test_gltf_texture_decode_expands_to_rgba():
    from raytracer2.scene.gltf import _decode_image

    gray = np.arange(12, dtype=np.uint8).reshape(3, 4) * 20
    rgba = _decode_image(encode_png(gray, filter_type=4))
    assert rgba.shape == (3, 4, 4)
    np.testing.assert_array_equal(rgba[..., 0], gray)
    np.testing.assert_array_equal(rgba[..., 2], gray)
    assert (rgba[..., 3] == 255).all()


def test_unsupported_png_is_reported():
    data = bytearray(encode_png(np.zeros((2, 2, 3), np.uint8)))
    data[24] = 16  # IHDR bit depth -> 16
    with pytest.raises(UnsupportedPNG):
        decode_png(bytes(data))
