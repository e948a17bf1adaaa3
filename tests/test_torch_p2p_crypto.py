"""The port's tunnel primitives (``spacedrive_tpu_torch/p2p/_crypto.py``):
X25519, Ed25519, HKDF-SHA256 and ChaCha20-Poly1305, the native C++ forms
(``csrc/p2pcrypto.cpp``, built by g++) and their plain Python twins,
against the RFC vectors and, on seeded random inputs, against the
``cryptography`` package the JAX package's tunnel uses. The JAX and port
identities are one file's bytes."""

import numpy as np
import pytest
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives import serialization as ser
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
from cryptography.hazmat.primitives.kdf.hkdf import HKDF

from spacedrive_tpu.p2p import identity as jax_identity
from spacedrive_tpu_torch.p2p import _crypto
from spacedrive_tpu_torch.p2p import identity

H = bytes.fromhex
NATIVE = [True, False]
FORMS = pytest.mark.parametrize("native", NATIVE, ids=["native", "plain"])

# RFC 7748 §5.2 (one X25519 call each) and §6.1 (the DH exchange).
X25519_VECTORS = [
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
]
ALICE = ("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
         "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
BOB = ("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb",
       "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
SHARED = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"

# RFC 8032 §7.1, tests 1-3: (secret, public, message, signature).
ED25519_VECTORS = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e"
     "39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e43e15996e458f"
     "3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b538d16f290ae67"
     "f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]

# RFC 5869 A.1-A.3: (ikm, salt, info, length, okm).
HKDF_VECTORS = [
    ("0b" * 22, "000102030405060708090a0b0c", "f0f1f2f3f4f5f6f7f8f9", 42,
     "3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf34007208d5b887185865"),
    (bytes(range(0x00, 0x50)).hex(), bytes(range(0x60, 0xb0)).hex(),
     bytes(range(0xb0, 0x100)).hex(), 82,
     "b11e398dc80327a1c8e7f78c596a49344f012eda2d4efad8a050cc4c19afa97c59045a99cac7827271cb"
     "41c65e590e09da3275600c2f09b8367793a9aca3db71cc30c58179ec3e87c14c01d5c1f3434f1d87"),
    ("0b" * 22, "", "", 42,
     "8da4e775a563c18f715f802a063c5a31b8a11f5c5ee1879ec3454e5f3c738d2d9d201395faa4b61a96c8"),
]

# RFC 8439 §2.8.2.
AEAD_KEY = bytes(range(0x80, 0xa0))
AEAD_NONCE = H("070000004041424344454647")
AEAD_AAD = H("50515253c0c1c2c3c4c5c6c7")
AEAD_PLAIN = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one "
              b"tip for the future, sunscreen would be it.")
AEAD_SEALED = H(
    "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d63dbea45e8ca9671282fa"
    "fb69da92728b1a71de0a9e060b2905d6a5b67ecd3b3692ddbd7f2d778b8c9803aee328091b58fab324e4"
    "fad675945585808b4831d7bc3ff4def08e4b7a9de576d26586cec64b6116"
    "1ae10b594f09e26a7e902ecbd0600691")


def _x25519(native):
    return _crypto.x25519 if native else _crypto.x25519_plain


def _seal(native):
    return _crypto.seal if native else _crypto.seal_plain


def _open(native):
    return _crypto.open_ if native else _crypto.open_plain


@FORMS
@pytest.mark.parametrize("k,u,out", X25519_VECTORS, ids=["5.2-1", "5.2-2"])
def test_x25519_rfc7748_vectors(native, k, u, out):
    assert _x25519(native)(H(k), H(u)) == H(out)


@FORMS
def test_x25519_rfc7748_diffie_hellman(native):
    assert _crypto.x25519_public(H(ALICE[0]), native) == H(ALICE[1])
    assert _crypto.x25519_public(H(BOB[0]), native) == H(BOB[1])
    assert _crypto.x25519_shared(H(ALICE[0]), H(BOB[1]), native) == H(SHARED)
    assert _crypto.x25519_shared(H(BOB[0]), H(ALICE[1]), native) == H(SHARED)


def test_x25519_rfc7748_iterated_native():
    """§5.2's iteration: k, u = X25519(k, u), k, 1000 times."""
    k = u = (9).to_bytes(32, "little")
    for i in range(1000):
        k, u = _crypto.x25519(k, u), k
        if i == 0:
            assert k == H("422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079")
    assert k == H("684cf59ba83309552800ef566f2f4d3c1c3887c49360e3875f2eb94d99532c51")


@FORMS
def test_x25519_refuses_an_all_zero_shared_secret(native):
    with pytest.raises(ValueError):
        _crypto.x25519_shared(H(ALICE[0]), bytes(32), native)


@FORMS
@pytest.mark.parametrize("secret,public,msg,sig", ED25519_VECTORS, ids=["t1", "t2", "t3"])
def test_ed25519_rfc8032_vectors(native, secret, public, msg, sig):
    assert _crypto.ed25519_public(H(secret), native) == H(public)
    assert _crypto.ed25519_sign(H(secret), H(msg), native) == H(sig)
    assert _crypto.ed25519_verify(H(public), H(msg), H(sig), native)
    bad = bytearray(H(sig))
    bad[5] ^= 0x10
    assert not _crypto.ed25519_verify(H(public), H(msg), bytes(bad), native)
    assert not _crypto.ed25519_verify(H(public), H(msg) + b"x", H(sig), native)


@FORMS
def test_ed25519_refuses_a_high_s_and_a_public_key_off_the_curve(native):
    secret, public, msg, sig = ED25519_VECTORS[0]
    s = int.from_bytes(H(sig)[32:], "little") + _crypto.L
    assert not _crypto.ed25519_verify(H(public), b"", H(sig)[:32] + s.to_bytes(32, "little"),
                                      native)
    off = (2).to_bytes(32, "little")  # y = 2: x^2 is not a square
    assert not _crypto.ed25519_verify(off, b"", H(sig), native)


@pytest.mark.parametrize("ikm,salt,info,length,okm", HKDF_VECTORS, ids=["A.1", "A.2", "A.3"])
def test_hkdf_rfc5869_vectors(ikm, salt, info, length, okm):
    assert _crypto.hkdf_sha256(H(ikm), H(salt), H(info), length) == H(okm)


@FORMS
def test_chacha20_poly1305_rfc8439_vector(native):
    assert _seal(native)(AEAD_KEY, AEAD_NONCE, AEAD_PLAIN, AEAD_AAD) == AEAD_SEALED
    assert _open(native)(AEAD_KEY, AEAD_NONCE, AEAD_SEALED, AEAD_AAD) == AEAD_PLAIN


def _raw_public(key) -> bytes:
    return key.public_key().public_bytes(ser.Encoding.Raw, ser.PublicFormat.Raw)


@FORMS
@pytest.mark.parametrize("seed", range(6))
def test_random_inputs_agree_with_cryptography(native, seed):
    rng = np.random.default_rng(seed)
    draw = lambda n: rng.integers(0, 256, n, np.uint8).tobytes()  # noqa: E731
    k, other = draw(32), draw(32)
    xk = X25519PrivateKey.from_private_bytes(k)
    xo = X25519PrivateKey.from_private_bytes(other)
    assert _crypto.x25519_public(k, native) == _raw_public(xk)
    assert _crypto.x25519_shared(k, _raw_public(xo), native) == xk.exchange(xo.public_key())
    ek = Ed25519PrivateKey.from_private_bytes(k)
    msg = draw(int(rng.integers(0, 300)))
    assert _crypto.ed25519_public(k, native) == _raw_public(ek)
    assert _crypto.ed25519_sign(k, msg, native) == ek.sign(msg)
    assert _crypto.ed25519_verify(_raw_public(ek), msg, ek.sign(msg), native)
    ikm, salt, info = draw(32), draw(int(rng.integers(0, 40))), draw(int(rng.integers(0, 40)))
    n = int(rng.integers(1, 200))
    assert _crypto.hkdf_sha256(ikm, salt, info, n) == HKDF(
        hashes.SHA256(), n, salt or None, info).derive(ikm)
    key, nonce = draw(32), draw(12)
    plain, aad = draw(int(rng.integers(0, 3000))), draw(int(rng.integers(0, 70)))
    sealed = ChaCha20Poly1305(key).encrypt(nonce, plain, aad)
    assert _seal(native)(key, nonce, plain, aad) == sealed
    assert _open(native)(key, nonce, sealed, aad) == plain


@FORMS
@pytest.mark.parametrize("where", ["ciphertext", "tag", "aad", "nonce", "short"])
def test_a_tampered_frame_is_refused(native, where):
    key, nonce = bytes(range(32)), bytes(12)
    sealed = _crypto.seal(key, nonce, b"frame body " * 9, b"")
    aad = b""
    if where == "ciphertext":
        sealed = bytes([sealed[0] ^ 1]) + sealed[1:]
    elif where == "tag":
        sealed = sealed[:-1] + bytes([sealed[-1] ^ 0x80])
    elif where == "aad":
        aad = b"x"
    elif where == "nonce":
        nonce = (1).to_bytes(12, "big")
    else:
        sealed = sealed[:15]
    with pytest.raises(_crypto.InvalidTag):
        _open(native)(key, nonce, sealed, aad)


def test_tunnel_aead_matches_cryptography_over_counter_nonces():
    """The tunnel's AEAD object: frame k sealed under nonce k, big-endian."""
    key = bytes(range(1, 33))
    ours, theirs = _crypto.ChaCha20Poly1305(key), ChaCha20Poly1305(key)
    for k in (0, 1, 255, 2**40):
        nonce = k.to_bytes(12, "big")
        msg = bytes([k % 251]) * (k % 97 + 1)
        assert ours.encrypt(nonce, msg, None) == theirs.encrypt(nonce, msg, None)
        assert ours.decrypt(nonce, theirs.encrypt(nonce, msg, None), None) == msg


def test_one_identity_file_serves_either_package():
    jax_id = jax_identity.Identity()
    port_id = identity.Identity(jax_id.to_bytes())
    assert port_id.to_bytes() == jax_id.to_bytes()
    assert port_id.to_remote_identity().to_bytes() == jax_id.to_remote_identity().to_bytes()
    msg = b"ephemeral key and nonce"
    assert port_id.sign(msg) == jax_id.sign(msg)
    assert jax_id.to_remote_identity().verify(port_id.sign(msg), msg)
    assert port_id.to_remote_identity().verify(jax_id.sign(msg), msg)
    back = jax_identity.Identity(identity.Identity().to_bytes())
    assert len(back.to_bytes()) == 32
    with pytest.raises(ValueError):
        identity.RemoteIdentity(b"short")
