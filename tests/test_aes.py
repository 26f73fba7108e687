"""NumPy AES-128 (stack/aes.py) and the LTE algorithms built on it:
published vectors, plus randomised agreement with the `cryptography`
package where it is installed."""

import numpy as np
import pytest

from srslte_emane_tpu.stack import aes, security

RFC4493_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
RFC4493_MSG = bytes.fromhex(
    "6bc1bee22e409f96e93d7e117393172a"
    "ae2d8a571e03ac9c9eb76fac45af8e51"
    "30c81c46a35ce411e5fbc1191a0a52ef"
    "f69f2445df4f9b17ad2b417be66c3710")


def test_fips197_vector():
    # FIPS-197 Appendix C.1
    ct = aes.ecb(bytes(range(16)),
                 bytes.fromhex("00112233445566778899aabbccddeeff"))
    assert ct.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_key_schedule_last_round_key():
    # FIPS-197 Appendix A.1: w[40..43] for key 2b7e1516...
    assert aes.expand_key(RFC4493_KEY)[10].tobytes().hex() == \
        "d014f9a8c9ee2589e13f0cc8b6630ca6"


@pytest.mark.parametrize("n,tag", [
    (0, "bb1d6929e95937287fa37d129b756746"),
    (16, "070a16b46b4d4144f79bdd9dd04a287c"),
    (40, "dfa66747de9ae63030ca32611497c827"),
    (64, "51f0bebf7e3b9d92fc49741779363cfe"),
])
def test_cmac_rfc4493_vectors(n, tag):
    assert aes.cmac(RFC4493_KEY, RFC4493_MSG[:n]).hex() == tag


def test_eea2_33401_test_set_1():
    # TS 33.401 Annex C.1, 128-EEA2 test set 1 (253 bits: the last byte's
    # three unused bits are zero in the published ciphertext)
    key = bytes.fromhex("d3c5d592327fb11c4035c6680af8c6d1")
    pt = bytes.fromhex("981ba6824c1bfb1ab485472029b71d80"
                       "8ce33e2cc3c0b5fc1f3de8a6dc66b1f0")
    ct = security.eea2(key, 0x398A59B4, 0x15, 1, pt)
    want = bytes.fromhex("e9fed8a63d155304d71df20bf3e82214"
                         "b20ed7dad2f233dc3c22d7bdeeed8e78")
    assert ct[:31] == want[:31] and ct[31] & 0xF8 == want[31]


def test_eia2_33401_test_set_2():
    # TS 33.401 Annex C.2, 128-EIA2 test set 2 (64-bit message)
    key = bytes.fromhex("d3c5d592327fb11c4035c6680af8c6d1")
    mac = security.eia2(key, 0x398A59B4, 0x1A, 1,
                        bytes.fromhex("484583d5afe082ae"))
    assert mac.hex() == "b93787e6"


def test_ctr_counter_carries_across_64_bits():
    key = bytes(range(16))
    iv = bytes(8) + b"\xff" * 8
    blocks = np.frombuffer(aes.ctr(key, iv, bytes(32)), np.uint8)
    want = [aes.ecb(key, iv), aes.ecb(key, bytes(7) + b"\x01" + bytes(8))]
    assert blocks.tobytes() == b"".join(want)


def test_rejects_wrong_key_length():
    with pytest.raises(ValueError):
        aes.ecb(bytes(15), bytes(16))


@pytest.mark.parametrize("seed", range(3))
def test_agrees_with_cryptography(seed):
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.ciphers import Cipher, modes
    from cryptography.hazmat.primitives.ciphers.algorithms import AES
    from cryptography.hazmat.primitives.cmac import CMAC

    rng = np.random.default_rng(seed)
    for n in (0, 1, 15, 16, 17, 47, 48, 300, 1500):
        key, iv, data = rng.bytes(16), rng.bytes(16), rng.bytes(n)
        enc = Cipher(AES(key), modes.CTR(iv)).encryptor()
        assert aes.ctr(key, iv, data) == enc.update(data) + enc.finalize()
        mac = CMAC(AES(key))
        mac.update(data)
        assert aes.cmac(key, data) == mac.finalize()
    key = rng.bytes(16)
    blocks = rng.integers(0, 256, (7, 16), dtype=np.uint8)
    enc = Cipher(AES(key), modes.ECB()).encryptor()
    want = enc.update(blocks.tobytes()) + enc.finalize()
    assert aes.encrypt_blocks(key, blocks).tobytes() == want
