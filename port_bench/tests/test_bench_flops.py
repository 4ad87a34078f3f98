"""flops.py against a count written out by hand for config-f."""
from port_bench.flops import gru_reactor_flops, mapping_flops, synthesis_flops

STYLE = 512
# (resolution, input channels, output channels) of each level after the 4 px block, config-f
LEVELS = [(8, 512, 512), (16, 512, 512), (32, 512, 512), (64, 512, 512), (128, 512, 256), (256, 256, 128),
          (512, 128, 64), (1024, 64, 32)]


def hand_count(top: int) -> int:
    macs = 0
    # 4 px block: style products and demodulation of conv1, a 3x3 conv on 4x4, to_rgb
    macs += STYLE * 512 + 512 * 512 + 512 * 512 * 9 * 16
    macs += STYLE * 512 + 512 * 3 * 16
    for r, cin, cout in LEVELS:
        if r > top:
            break
        h = r // 2
        # up-conv: style, demodulation, transposed 3x3 over the h x h input, 4x4 blur of the r x r output
        macs += STYLE * cin + cin * cout + cin * cout * 9 * h * h + 16 * cout * r * r
        # conv: style, demodulation, 3x3 over r x r
        macs += STYLE * cout + cout * cout + cout * cout * 9 * r * r
        # to_rgb, and the skip's 4x4 upsampling blur on 3 channels
        macs += STYLE * cout + cout * 3 * r * r + 16 * 3 * r * r
    return 2 * macs


def test_config_f_1024():
    assert synthesis_flops(1024) == hand_count(1024)
    assert abs(synthesis_flops(1024) / 1e9 - 150.77) < 0.01


def test_config_f_256():
    assert synthesis_flops(256) == hand_count(256)


def test_mapping_and_reactor():
    assert mapping_flops() == 8 * 2 * 512 * 512
    # envelope reactor of the run of record: 59 features, width 3 * 32 + 2 * 4 = 104, 4 GRU layers
    h = 104
    assert gru_reactor_flops(59, h, 4) == 2 * 59 * h + 4 * 2 * 3 * h * 2 * h + 2 * h * h
