"""The port's device emulation layer (``repro_torch.core.emulation``): the
reference's tests (``tests/test_emulation.py``) held against the port's copy,
and the chip registry against the reference's."""

import threading

import numpy as np
import pytest

from repro_torch.core.emulation import (EmulatedChannel, EmulatedCollective,
                                        PhantomReadError, VirtualDeviceContext,
                                        VirtualOOMError)
from repro_torch.core.hardware import TPU_V5E, get_chip

import torch

torch.set_num_threads(2)    # the suite runs in several workers at once


def test_split_state_thresholding():
    ctx = VirtualDeviceContext(2, TPU_V5E)
    meta = ctx.malloc(1024, 0, tag="block_table")
    big = ctx.malloc(512 << 20, 1, tag="kv_pool")
    # metadata: faithful read/write
    meta.write(np.arange(16, dtype=np.uint8))
    assert meta.read(4).tolist() == [0, 1, 2, 3]
    # compute buffer: writes are accounted no-ops, reads FAULT
    big.write(None)
    assert big.writes == 1
    with pytest.raises(PhantomReadError):
        big.read()


def test_virtual_oom_is_a_prediction():
    ctx = VirtualDeviceContext(1, TPU_V5E)
    ctx.malloc(int(10e9), 0, tag="weights")
    with pytest.raises(VirtualOOMError):
        ctx.malloc(int(8e9), 0, tag="kv")       # 18 GB > 16 GB HBM
    # freeing restores capacity
    b = ctx.malloc(int(4e9), 0, tag="kv-small")
    ctx.free(b)
    ctx.malloc(int(5.9e9), 0, tag="kv-again")


def test_double_free_detected():
    ctx = VirtualDeviceContext(1, TPU_V5E)
    b = ctx.malloc(1 << 20, 0)
    ctx.free(b)
    with pytest.raises(RuntimeError):
        ctx.free(b)


def test_memory_report_peaks():
    ctx = VirtualDeviceContext(2, TPU_V5E)
    a = ctx.malloc(1 << 30, 0)
    ctx.free(a)
    ctx.malloc(1 << 20, 0)
    rep = ctx.memory_report()
    assert rep["per_device_peak_bytes"][0] == 1 << 30
    assert rep["per_device_live_bytes"][0] == 1 << 20


def test_collective_exit_is_max_plus_duration():
    coll = EmulatedCollective(3, "ar")
    outs = {}

    def worker(i, t, d):
        outs[i] = coll.arrive(t, d)

    ts = [threading.Thread(target=worker, args=(i, t, d))
          for i, (t, d) in enumerate([(1.0, 0.1), (2.0, 0.1), (1.5, 0.1)])]
    for t in ts: t.start()
    for t in ts: t.join()
    assert all(v == pytest.approx(2.1) for v in outs.values())


def test_collective_straggler_timeout():
    coll = EmulatedCollective(2, "ar")
    with pytest.raises(TimeoutError):
        coll.arrive(0.0, 0.0, timeout=0.05)


def test_channel_transfer_time_and_order():
    ch = EmulatedChannel(bandwidth=100e9, name="kv")
    ch.send("req-1", t_virtual=5.0, nbytes=int(1e9))     # 10 ms transfer
    ch.send("req-2", t_virtual=6.0, nbytes=0)
    p1, t1 = ch.recv()
    p2, t2 = ch.recv()
    assert p1 == "req-1" and t1 == pytest.approx(5.01)
    assert p2 == "req-2" and t2 == pytest.approx(6.0)


def test_chip_registry():
    assert get_chip("tpu-v5e").peak_flops_bf16 == pytest.approx(197e12)
    with pytest.raises(KeyError):
        get_chip("tpu-v9")


def test_chip_registry_equals_the_reference():
    from dataclasses import asdict

    from repro.core import hardware as ref
    from repro_torch.core import hardware as port
    assert sorted(port.CHIPS) == sorted(ref.CHIPS)
    for name in ref.CHIPS:
        assert asdict(port.CHIPS[name]) == asdict(ref.CHIPS[name])
    for alias in ref.CHIP_ALIASES:
        assert asdict(port.get_chip(alias)) == asdict(ref.get_chip(alias))
