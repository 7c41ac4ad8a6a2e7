"""Pillow's 8-bit image operations as the port computes them in numpy
(prismer_tpu_torch.data.pil_warp and .pil_ops), held to Pillow bit for bit
on seeded random images: BICUBIC and BILINEAR resizes up and down (640 x
480 to 480 and 384 among them), the BILINEAR affine transform of
RandAugment's shears and translations, NEAREST rotate, crop with a box past
the edge, the horizontal flip, autocontrast, equalize, Brightness and
Sharpness at several factors, and the mode conversions of the readers."""

import numpy as np
import pytest
from PIL import Image, ImageEnhance, ImageOps

from prismer_tpu_torch.data import pil_ops, pil_warp

RESIZES = [((640, 480), (480, 480)), ((640, 480), (384, 384)),
           ((500, 375), (480, 480)), ((97, 61), (480, 480)),
           ((37, 29), (20, 41)), ((300, 200), (301, 199)), ((5, 5), (1, 1))]


def rgb(seed, w, h, channels=3, lo=0, hi=256):
    shape = (h, w) if channels == 1 else (h, w, channels)
    return np.random.default_rng(seed).integers(lo, hi, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_bicubic_and_bilinear_equal_pil(src, dst, channels):
    a = rgb(sum(src) + channels, *src, channels)
    im = Image.fromarray(a)
    np.testing.assert_array_equal(pil_warp.resize_bicubic_u8(a, dst),
                                  np.asarray(im.resize(dst, Image.BICUBIC)))
    np.testing.assert_array_equal(pil_warp.resize_bilinear_u8(a, dst),
                                  np.asarray(im.resize(dst, Image.BILINEAR)))


@pytest.mark.parametrize("size", [(480, 480), (384, 384), (37, 23)])
def test_affine_bilinear_equals_pil(size):
    a = rgb(size[0], *size)
    im = Image.fromarray(a)
    for v in (0.15, -0.15, 0.3):
        for c in [(1.0, v, 0.0, 0.0, 1.0, 0.0), (1.0, 0.0, 0.0, v, 1.0, 0.0),
                  (1.0, 0.0, v * size[0], 0.0, 1.0, 0.0),
                  (1.0, 0.0, 0.0, 0.0, 1.0, v * size[1]),
                  (0.9, 0.1, 3.5, -0.2, 1.1, -2.25)]:
            want = im.transform(im.size, Image.AFFINE, c,
                                resample=Image.BILINEAR, fillcolor=(0, 0, 0))
            np.testing.assert_array_equal(
                pil_warp.affine_bilinear_u8(a, c, (0, 0, 0)),
                np.asarray(want), err_msg=str(c))
    fill = (9, 200, 31)
    c = (1.0, 0.0, 0.3 * size[0], 0.0, 1.0, 0.0)
    np.testing.assert_array_equal(
        pil_warp.affine_bilinear_u8(a, c, fill),
        np.asarray(im.transform(im.size, Image.AFFINE, c,
                                resample=Image.BILINEAR, fillcolor=fill)))


@pytest.mark.parametrize("size", [(480, 480), (384, 384), (37, 23)])
def test_rotate_equals_pil(size):
    a = rgb(size[1], *size)
    im = Image.fromarray(a)
    for angle in (15.0, -15.0, 345.0, 7.3):
        np.testing.assert_array_equal(
            pil_warp.rotate_nearest_u8(a, angle, (0, 0, 0)),
            np.asarray(im.rotate(angle, fillcolor=(0, 0, 0))))


def test_crop_and_flip_equal_pil():
    a = rgb(3, 50, 40)
    im = Image.fromarray(a)
    for box in [(0, 0, 10, 10), (-5, -3, 20, 30), (45, 35, 57, 42),
                (3, 4, 50, 40)]:
        np.testing.assert_array_equal(pil_warp.crop_u8(a, box),
                                      np.asarray(im.crop(box)))
    np.testing.assert_array_equal(
        pil_warp.flip_lr_u8(a),
        np.asarray(im.transpose(Image.FLIP_LEFT_RIGHT)))


def _images():
    rng = np.random.default_rng(4)
    for shape in [(48, 64, 3), (3, 3, 3), (240, 240, 3), (2, 5, 3),
                  (40, 40)]:
        yield rng.integers(0, 256, shape, dtype=np.uint8)
        yield rng.integers(60, 140, shape, dtype=np.uint8)
        yield np.full(shape, 77, np.uint8)
        yield rng.choice(np.array([3, 250], np.uint8), shape)


def test_autocontrast_and_equalize_equal_pil():
    for a in _images():
        im = Image.fromarray(a)
        np.testing.assert_array_equal(pil_ops.autocontrast(a),
                                      np.asarray(ImageOps.autocontrast(im)))
        np.testing.assert_array_equal(pil_ops.equalize(a),
                                      np.asarray(ImageOps.equalize(im)))


@pytest.mark.parametrize("factor", [0.0, 0.1, 0.5, 0.999, 1.0, 1.3, 1.9,
                                    (5 / 10.0) * (1.9 - 0.1) + 0.1])
def test_brightness_and_sharpness_equal_pil(factor):
    for a in _images():
        if a.ndim != 3:
            continue
        im = Image.fromarray(a)
        np.testing.assert_array_equal(
            pil_ops.brightness(a, factor),
            np.asarray(ImageEnhance.Brightness(im).enhance(factor)))
        np.testing.assert_array_equal(
            pil_ops.sharpness(a, factor),
            np.asarray(ImageEnhance.Sharpness(im).enhance(factor)))


def test_mode_conversions_equal_pil():
    a3, a4, a1 = rgb(5, 30, 20), rgb(6, 30, 20, 4), rgb(7, 30, 20, 1)
    np.testing.assert_array_equal(pil_ops.to_mode(a3, "L"),
                                  np.asarray(Image.fromarray(a3).convert("L")))
    np.testing.assert_array_equal(
        pil_ops.to_mode(a4, "RGB"), np.asarray(Image.fromarray(a4)
                                               .convert("RGB")))
    np.testing.assert_array_equal(pil_ops.to_mode(a4, "L"),
                                  np.asarray(Image.fromarray(a4).convert("L")))
    np.testing.assert_array_equal(
        pil_ops.to_mode(a1, "RGB"), np.asarray(Image.fromarray(a1)
                                               .convert("RGB")))
    assert pil_ops.to_mode(a1, "L") is a1 and pil_ops.to_mode(a3, "RGB") is a3
