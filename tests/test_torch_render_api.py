"""The torch port's render API around the engines, on the CPU.

* ``render(n, segment=s)``, ``render_long(n, segment=s)`` and one render
  agree bit for bit on patches without Noise (unbatched, batched, and in
  buffer-feedback mode); with Noise the two segmented forms agree (segment
  ``i`` draws from ``fold_in(key, i)``).
* ``render_stream`` blocks, concatenated, equal one render, also with
  ``voices=V``.
* ``render_many`` groups patches by topology and keeps the input order.
* ``migrate_state`` equals the JAX package's on a topology edit.
* The device default: with no CUDA device, the entry points raise and name
  ``device="cpu"``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import srack_tpu as st
from srack_tpu.compiler import migrate_state as jax_migrate

import srack_tpu_torch as stt
from srack_tpu_torch import interop

SR = 4800


def _case(name):
    cfg = stt.AudioConfig(sample_rate=SR, block_size=16, channels=1)
    if name == "feedback_buffer":
        cfg = stt.AudioConfig(sample_rate=SR, block_size=16, channels=1,
                              buffer_feedback=True)
        return stt.presets.feedback_patch(cfg)
    return getattr(stt.presets, name)(cfg)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", ["subtractive_voice", "sequencer_patch",
                                  "feedback_buffer"])
def test_segments_equal_one_render(name, batched):
    patch = _case(name)
    n, seg = 480, 96  # the voice's gate opens after ~250 samples
    params = stt.presets.farm_params(patch, 3) if batched else None
    whole, _, s_whole = stt.compile_patch(patch).render(
        n, params=params, batched=batched, device="cpu")
    parts, _, s_parts = stt.compile_patch(patch).render(
        n, params=params, batched=batched, device="cpu", segment=seg)
    longr, s_long = stt.render_long(patch, n, segment=seg, params=params,
                                    batched=batched, device="cpu")
    assert float(whole.abs().max()) > 0.0
    for got, state in ((parts, s_parts), (longr, s_long)):
        torch.testing.assert_close(got, whole, atol=0, rtol=0)
        for a, b in zip(stt.compiler.tree_leaves(state),
                        stt.compiler.tree_leaves(s_whole)):
            assert torch.equal(a, b)
    # render_long's last segment may be shorter
    odd, _ = stt.render_long(patch, n, segment=208, params=params,
                             batched=batched, device="cpu")
    torch.testing.assert_close(odd, whole, atol=0, rtol=0)


def test_noise_segments_draw_per_segment():
    p = stt.Patch(stt.AudioConfig(sample_rate=SR, channels=1))
    noise = p.add("Noise", seed=2)
    flt = p.add("Moog Filter", freq=0.3)
    p.connect(noise, 0, flt, "Audio")
    p.connect(flt, 0, p.output, 0)
    a, _, _ = stt.render(p, 96, key=5, segment=32, device="cpu")
    b, _ = stt.render_long(p, 96, key=5, segment=32, device="cpu")
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    one, _, _ = stt.render(p, 96, key=5, device="cpu")
    assert not torch.equal(a, one)  # fresh draws per segment


@pytest.mark.parametrize("voices", [None, 3])
def test_stream_blocks_equal_one_render(voices):
    patch = _case("sequencer_patch")
    blocks = list(stt.render_stream(patch, n_blocks=6, voices=voices,
                                    device="cpu"))
    streamed = torch.cat([a for a, _, _ in blocks], dim=-1)
    params = (stt.replicate_params(patch.params(), voices) if voices
              else None)
    whole, _, state = stt.compile_patch(patch).render(
        96, params=params, batched=voices is not None, device="cpu")
    torch.testing.assert_close(streamed, whole, atol=0, rtol=0)
    for a, b in zip(stt.compiler.tree_leaves(blocks[-1][2]),
                    stt.compiler.tree_leaves(state)):
        assert torch.equal(a, b)


def test_stream_holds_automation_past_its_end():
    p = stt.Patch(stt.AudioConfig(sample_rate=SR, block_size=16, channels=1))
    osc = p.add("Oscillator", val=0.0)
    p.connect(osc, "Sine", p.output, 0)
    lane = np.linspace(-1.0, 0.0, 40).astype(np.float32)
    blocks = [a for a, _, _ in stt.render_stream(
        p, n_blocks=4, automation={(osc, "val"): lane}, device="cpu")]
    held = np.concatenate([lane, np.full(24, lane[-1], np.float32)])
    want, _, _ = stt.render(p, 64, automation={(osc, "val"): held},
                            device="cpu")
    torch.testing.assert_close(torch.cat(blocks, dim=-1), want, atol=0,
                               rtol=0)


def test_render_many_groups_by_topology_in_order():
    cfg = stt.AudioConfig(sample_rate=SR, channels=1)
    patches = [stt.presets.sine_patch(cfg), stt.presets.subtractive_voice(cfg),
               stt.presets.sine_patch(cfg), stt.presets.feedback_patch(cfg)]
    patches[2].set_params(patches[2].module_ids[1], val=-1.0)
    outs = stt.render_many(patches, 64, device="cpu")
    assert len(outs) == 4
    for p, got in zip(patches, outs):
        want, _, _ = stt.render(p, 64, device="cpu")
        assert tuple(got.shape) == (1, 64)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not torch.equal(outs[0], outs[2])


def _edit(p):
    """Delete a module, add one, rewire: the same edit in both packages."""
    ids = {inst.name: inst.id for inst in p}
    p.delete_module(ids["zero"])
    new = p.add("Oscillator", val=-2.0, name="new")
    p.connect(new, "Sine", ids["mix"], 2)
    p.connect(ids["vca_off"], 0, ids["vco_b"], "Sync")  # a new fb read


def test_migrate_state_matches_jax():
    tcfg = stt.AudioConfig(sample_rate=SR, channels=3)
    jcfg = st.AudioConfig(sample_rate=SR, channels=3)
    tp = stt.presets.kernel_check_patch(tcfg)
    jp = stt.presets.kernel_check_patch(jcfg, patch_cls=st.Patch)
    old_t, old_j = stt.compile_patch(tp), st.compile_patch(jp)
    params = stt.presets.farm_params(tp, 3)
    _, _, state = old_t.render(40, params=params, batched=True,
                               device="cpu")
    _edit(tp)
    _edit(jp)
    new_t, new_j = stt.compile_patch(tp), st.compile_patch(jp)
    assert new_t.fb_keys == tuple(new_j.fb_keys)
    got = stt.migrate_state(old_t, new_t, state)
    jstate = jax.tree.map(jnp.asarray, interop.to_numpy(state))
    want = jax_migrate(old_j, new_j, jstate)
    assert set(got["states"]) == set(want["states"])
    assert set(got["fb"]) == set(want["fb"])
    for mid, sd in want["states"].items():
        assert set(got["states"][mid]) == set(sd), mid
        for key, w in sd.items():
            g = got["states"][mid][key].numpy()
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, (mid, key)
            np.testing.assert_array_equal(g, w, err_msg=f"{mid}.{key}")
    for k, w in want["fb"].items():
        np.testing.assert_array_equal(got["fb"][k].numpy(), np.asarray(w))
    # the migrated state renders on
    audio, _, _ = new_t.render(16, params=stt.presets.farm_params(tp, 3),
                               state=got, batched=True, device="cpu")
    assert bool(torch.isfinite(audio).all())


def test_device_default_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    patch = _case("subtractive_voice")
    params = stt.presets.farm_params(patch, 2)
    calls = [lambda: stt.render(patch, 16),
             lambda: stt.render_batch(patch, 16, params=params),
             lambda: stt.compile_patch(patch).render(16),
             lambda: stt.render_long(patch, 16),
             lambda: next(stt.render_stream(patch, n_blocks=1)),
             lambda: stt.render_many([patch], 16)]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    audio, _, _ = stt.render(patch, 16, device="cpu")
    assert audio.device.type == "cpu"
