"""Serialization / profiling utility tests."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiocodec_tpu import streaming
from audiocodec_tpu.codec import Codec
from audiocodec_tpu.utils import serialization


class TestCodecSerialization:
    def test_save_load_rebuilds_identically(self, tmp_path):
        codec = Codec.create(
            32000, filters_n=128, bark_bands_n=24, alpha=0.7,
            window_type="sine",
        )
        path = str(tmp_path / "codec.json")
        serialization.save_codec(path, codec)
        restored = serialization.load_codec(path)
        # deterministic precompute: every array rebuilds bit-identically
        for a, b in zip(
            jax.tree_util.tree_leaves(codec),
            jax.tree_util.tree_leaves(restored),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_none_window_and_pallas_flags(self, tmp_path):
        codec = Codec.create(16000, filters_n=256, window_type=None)
        path = str(tmp_path / "c.json")
        serialization.save_codec(path, codec)
        # the config records no transform-kernel choice any more...
        assert "use_pallas" not in serialization.codec_config(codec)
        assert "pallas_kernel" not in serialization.codec_config(codec)
        restored = serialization.load_codec(path)
        assert restored.mdct.window_type is None
        # ...and a checkpoint written with one loads and ignores it
        with open(path) as f:
            cfg = json.load(f)
        cfg["use_pallas"] = True
        with open(path, "w") as f:
            json.dump(cfg, f)
        old = serialization.load_codec(path)
        assert old.mdct.window_type is None
        assert not hasattr(old.mdct, "use_pallas")


class TestLegacyConfigCompat:
    def test_pallas_kernel_recorded_and_restored(self, tmp_path):
        """A checkpoint that recorded a kernel design loads to the same
        codec as one that did not: the design never affected
        quantization."""
        cfg = dict(
            serialization.codec_config(Codec.create(16000, filters_n=256)),
            use_pallas=True, pallas_kernel="radix",
        )
        path = str(tmp_path / "r.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        restored = serialization.load_codec(path)
        want = Codec.create(16000, filters_n=256)
        for a, b in zip(jax.tree_util.tree_leaves(restored),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_pre_pallas_kernel_config_defaults_to_mono(self, tmp_path):
        cfg = {
            "sample_rate": 16000, "filters_n": 256, "bark_bands_n": 32,
            "alpha": 0.6, "window_type": "vorbis",
            "compute_dtype": "float32", "fast_bf16": False,
            "use_pallas": False, "dct_precision": "highest",
            "bark_precision": "highest",
        }
        path = str(tmp_path / "legacy2.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        restored = serialization.load_codec(path)
        assert restored.mdct.dct_precision == "highest"
        assert restored.sidecar_grid == 0

    def test_pre_bark_precision_config_defaults_to_highest(self, tmp_path):
        """Configs saved before bark_precision existed were written by
        codecs that always ran Bark matmuls at HIGHEST; rebuilding them
        must preserve that (not follow dct_precision), or thresholds and
        step sizes diverge from the bitstreams that codec produced."""
        import json

        cfg = {
            "sample_rate": 16000, "filters_n": 256, "bark_bands_n": 32,
            "alpha": 0.6, "window_type": "vorbis",
            "compute_dtype": "float32", "fast_bf16": False,
            "use_pallas": False, "dct_precision": "default",
        }
        path = str(tmp_path / "legacy.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        restored = serialization.load_codec(path)
        assert restored.psycho.bark_precision == "highest"
        assert restored.mdct.dct_precision == "default"


class TestIneligibleKernelConfigDowngrade:
    def test_stale_use_pallas_size_downgrades_to_xla(self, tmp_path):
        """A checkpoint whose use_pallas choice an older kernel layer's
        size caps rejected loads like any other: the choice is ignored."""
        cfg = {
            "sample_rate": 48000, "filters_n": 2048, "bark_bands_n": 64,
            "alpha": 0.6, "window_type": "vorbis",
            "compute_dtype": "float32", "fast_bf16": False,
            "use_pallas": True, "dct_precision": "highest",
            "bark_precision": "highest",
        }
        path = str(tmp_path / "stale.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        restored = serialization.load_codec(path)
        assert restored.mdct.filters_n == 2048
        assert restored.mdct.dense_fwd is None

    def test_downgrade_via_create_retry_branch(self, tmp_path):
        """Retired kernel keys are dropped, but a config Codec.create
        rejects for any other reason must still raise, not silently
        degrade."""
        cfg = {
            "sample_rate": 48000, "filters_n": 2048, "bark_bands_n": 64,
            "alpha": 0.6, "window_type": "vorbis",
            "compute_dtype": "float32", "fast_bf16": False,
            "use_pallas": "inverse", "pallas_kernel": "mono",
            "dct_precision": "highest", "bark_precision": "highest",
        }
        path = str(tmp_path / "stale_kernel.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        restored = serialization.load_codec(path)
        assert restored.mdct.dct_precision == "highest"
        bad = dict(cfg, use_pallas=False, dct_precision="nonsense")
        bad_path = str(tmp_path / "bad.json")
        with open(bad_path, "w") as f:
            json.dump(bad, f)
        with pytest.raises(ValueError):
            serialization.load_codec(bad_path)


class TestStreamStateSerialization:
    def test_stream_resume_across_checkpoint(self, tmp_path):
        codec = Codec.create(16000, filters_n=64, bark_bands_n=16)
        mdct = codec.mdct
        rng = np.random.default_rng(0)
        x = jnp.asarray(
            rng.uniform(-1, 1, (1, 8 * 64, 1)), dtype=jnp.float32
        )
        carry = streaming.mdct_stream_init(mdct, 1, 1)
        carry, f1 = streaming.mdct_stream_step(mdct, carry, x[:, : 4 * 64])

        path = str(tmp_path / "state.npz")
        serialization.save_stream_state(path, carry, offset=4)
        enc, dec, offset = serialization.load_stream_state(path)
        assert offset == 4
        assert dec is None

        _, f2 = streaming.mdct_stream_step(mdct, enc, x[:, 4 * 64 :])
        got = np.concatenate([np.asarray(f1), np.asarray(f2)], axis=1)
        want = np.asarray(mdct.transform(x))[:, :-1]
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestPytreeCheckpoint:
    def test_params_roundtrip_exact(self, tmp_path):
        from audiocodec_tpu.models import spectral_ae as sae

        cfg = sae.SpectralAE(filters_n=64, hidden_n=32, latent_n=8)
        params = sae.init_params(jax.random.key(0), cfg)
        path = str(tmp_path / "params.npz")
        serialization.save_pytree(path, params)
        back = serialization.load_pytree(
            path, sae.init_params(jax.random.key(1), cfg)
        )
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert a.dtype == b.dtype

    def test_bfloat16_leaves_survive(self, tmp_path):
        from audiocodec_tpu.models import spectral_ae as sae

        cfg = sae.SpectralAE(filters_n=64, hidden_n=32, latent_n=8)
        params = sae.init_params(jax.random.key(2), cfg, jnp.bfloat16)
        path = str(tmp_path / "bf16.npz")
        serialization.save_pytree(path, params)
        back = serialization.load_pytree(path, params)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
            assert b.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint16), np.asarray(b).view(np.uint16)
            )

    def test_optimizer_state_roundtrip(self, tmp_path):
        import optax

        from audiocodec_tpu.models import spectral_ae as sae

        cfg = sae.SpectralAE(filters_n=64, hidden_n=32, latent_n=8)
        params = sae.init_params(jax.random.key(3), cfg)
        opt = optax.adam(1e-3)
        state = opt.init(params)
        path = str(tmp_path / "opt.npz")
        serialization.save_pytree(path, state)
        back = serialization.load_pytree(path, opt.init(params))
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_wrong_template_rejected(self, tmp_path):
        from audiocodec_tpu.models import spectral_ae as sae

        cfg = sae.SpectralAE(filters_n=64, hidden_n=32, latent_n=8)
        params = sae.init_params(jax.random.key(4), cfg)
        path = str(tmp_path / "p.npz")
        serialization.save_pytree(path, params)
        with pytest.raises(ValueError, match="leaves"):
            serialization.load_pytree(path, {"just_one": params["enc_w1"]})

    def test_training_resumes_exactly(self, tmp_path):
        """checkpoint(params, rvq_state, opt_state) mid-run; continuing
        from the reload matches continuing in-process bit-for-bit."""
        import optax

        from audiocodec_tpu.models import rvq as _rvq
        from audiocodec_tpu.models import spectral_ae as sae
        from audiocodec_tpu.parallel import mesh as _mesh

        codec = Codec.create(16000, filters_n=64, bark_bands_n=16)
        cfg = sae.SpectralAE(filters_n=64, hidden_n=32, latent_n=8)
        rcfg = _rvq.RVQ(stages=2, codebook_size=16, dim=8)
        mesh = _mesh.make_mesh(n_devices=1)
        step, opt = _rvq.make_train_step(
            codec, cfg, rcfg, mesh, optimizer=optax.adam(1e-3)
        )
        params = sae.init_params(jax.random.key(5), cfg)
        st = _rvq.init_state(jax.random.key(6), rcfg)
        opt_state = opt.init(params)
        rng = np.random.default_rng(0)
        x = jnp.asarray(
            rng.uniform(-0.5, 0.5, (2, 8 * 64, 1)), jnp.float32
        )
        for i in range(2):
            params, st, opt_state, _ = step(
                params, st, opt_state, x, jax.random.key(i), jnp.int32(i)
            )
        pp, ps, po = (str(tmp_path / f) for f in ("p.npz", "s.npz", "o.npz"))
        serialization.save_pytree(pp, params)
        serialization.save_pytree(ps, st)
        serialization.save_pytree(po, opt_state)

        def advance(params, st, opt_state):
            for i in (2, 3):
                params, st, opt_state, loss = step(
                    params, st, opt_state, x, jax.random.key(i),
                    jnp.int32(i),
                )
            return params, loss

        cont_params, cont_loss = advance(
            jax.tree.map(jnp.copy, params),
            jax.tree.map(jnp.copy, st),
            jax.tree.map(jnp.copy, opt_state),
        )
        r_params = serialization.load_pytree(
            pp, sae.init_params(jax.random.key(7), cfg)
        )
        r_st = serialization.load_pytree(
            ps, _rvq.init_state(jax.random.key(8), rcfg)
        )
        r_opt = serialization.load_pytree(po, opt.init(r_params))
        res_params, res_loss = advance(r_params, r_st, r_opt)
        assert float(cont_loss) == float(res_loss)
        for a, b in zip(
            jax.tree.leaves(cont_params), jax.tree.leaves(res_params)
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize(
    "retired",
    [
        {"use_pallas": True},
        {"use_pallas": "forward", "pallas_kernel": "radix"},
        {"use_pallas": "auto", "pallas_kernel": "auto"},
        {"pallas_kernel": "mono"},
    ],
)
def test_old_checkpoint_kernel_keys_ignored(tmp_path, retired):
    """Checkpoints written while a transform-kernel layer existed load to
    the codec a fresh create() builds: the keys are dropped."""
    want = Codec.create(22050, filters_n=256, bark_bands_n=32,
                        dct_precision="default")
    path = str(tmp_path / "old.json")
    with open(path, "w") as f:
        json.dump({**serialization.codec_config(want), **retired}, f)
    got = serialization.load_codec(path)
    assert got.mdct.dct_precision == "default"
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestCompileCache:
    def test_env_var_wins_and_nothing_is_set(self, monkeypatch, tmp_path):
        from audiocodec_tpu.utils import compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_checkout_jax_cache(self, monkeypatch):
        import os

        import audiocodec_tpu
        from audiocodec_tpu.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        checkout = os.path.dirname(
            os.path.dirname(os.path.abspath(audiocodec_tpu.__file__))
        )
        before = jax.config.jax_compilation_cache_dir
        try:
            path = compile_cache.enable()
            assert path == os.path.join(checkout, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
