"""The trace reduction (busy time, idle gaps named by the host's spans)
on events written out, and the frozen roofline."""
import numpy as np
from torch.autograd import DeviceType

from portbench import roofline, trace


class Ev:
    def __init__(self, name, start, dur, dev=DeviceType.CPU):
        self._n, self._s, self._d, self._t = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


def test_union_and_gaps():
    iv = np.array([[0, 2], [1, 3], [5, 6], [5.5, 5.7]], dtype=float)
    assert trace.union_length(iv) == 4.0
    assert trace.gaps(iv, -1, 8) == [(-1, 0), (3, 5), (6, 8)]


def test_read_profile_names_idle_gaps_by_the_host():
    cuda = DeviceType.CUDA
    ev = [Ev("portbench.window", 1000, 1000),
          Ev("portbench.read", 1000, 400), Ev("portbench.update", 1500, 400),
          Ev("void ns::bloom_probe_kernel<int>(long*)", 1100, 100, cuda),
          Ev("Memcpy DtoH (Device -> Pinned)", 1200, 50, cuda),
          Ev("void merge_tile_kernel(long*)", 1600, 100, cuda)]
    # a flush at host 1300-1400; the window opened at host 500: 1800-1900
    r = trace.read_profile(ev, 500, [("flush", 1300, 1400)])
    assert r.window_s == 1e-6 and r.device_events == 3
    assert np.isclose(r.busy_s, 250e-9)
    assert r.kernel_n == {"bloom_probe_kernel": 1, "merge_tile_kernel": 1,
                          "Memcpy DtoH (Device -> Pinned)": 1}
    # gaps 1000-1100 (in the read), 1250-1600 (between requests), 1700-2000
    # (its middle in the flush, inside the update)
    idle = {k: round(v * 1e9) for k, v in r.idle_by_host.items()}
    assert idle == {"read": 100, "client": 350, "flush": 300}
    bd = trace.breakdown(r)
    assert bd["device_ops"][0][0] == "bloom_probe_kernel"


def test_roofline_bounds():
    # 65,536 keys, a filter larger than the keys: bytes bound it
    n = 65_536
    assert roofline.probe_bound_s(n, 10**6) == n * 13 / roofline.HBM_BYTES_PER_S
    assert roofline.merge_bound_s(n, n) == 2 * n * 24 / roofline.HBM_BYTES_PER_S
    assert roofline.build_bound_s(n, 1000, 7) == \
        (n * 8 + 4000) / roofline.HBM_BYTES_PER_S
    # operations bound a probe only where a key costs more than its bytes
    assert roofline.bound_s(1, 1e6) == 1e6 / roofline.ALU_OPS_PER_S
