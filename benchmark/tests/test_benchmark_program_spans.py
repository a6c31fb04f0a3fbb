"""The six readers of the program's own spans and counters
(``sequoia_tpu_torch.utils.profiling``): known values from a recorder
filled by hand, all six reported by a traced CPU run of the tiny features
and train cells, and nothing of the benchmark that was there before
changed."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import common, run
from benchmark.tests import tiny
from benchmark.tests.test_benchmark_extend import digest
from sequoia_tpu_torch.utils import profiling

SERVING = ("kmeans_seed_ms_per_slide", "lloyd_ms_per_step", "lloyd_steps_per_slide",
           "host_syncs_per_slide")
TRAIN = ("step_host_ms.train", "batch_wait_ms.train")

#: sha256 of every file the benchmark had before these readers
BEFORE = {
    "__init__.py":
        "0a31c8c2665cf288638a007ba086085b6e5dce0b4f11962bb68b0f440879ee83",
    "arith.py":
        "55df975e7d1cf147c54fabc9eb3b28e6b4ea39e02128a13f0553cfefd8a54909",
    "common.py":
        "a06f9c88812742fe18b7ae9c0bab0fa62055ccefedb14f7aece31cef2425613f",
    "configs/sequoia-resnet50-vis.json":
        "9c3500cc39c54c717f4a451790bb83ca6cd02d48cfaf7c6ec85ab6cd125d1249",
    "configs/sequoia-uni-vitl16-vis.json":
        "20c44cdd6e0ad15e7aec4618838dfa46dca97fb6371fee60714bf677af9a5130",
    "control.py":
        "32793c635c83669b52ecf1a98189970e03bd4f3f4a8dcda81c41f4b7db5780d8",
    "entries/features.py":
        "f773622f131cb9a24efb2db6c3aa5ac6881fc7eabc39c09aff6426fd283d41a6",
    "entries/slides.py":
        "a3f7924b30077286f7c1a396d95dce9e4887857c065344aa859651ad6913ef29",
    "entries/train.py":
        "ac394d36b0fc18ad59ec9b8c90ee9833ddddd6ff45d02448e6b298917f99fac6",
    "limits/resnet50-vis.features.json":
        "d08b3b809947763a6e6955f1f5ef50a90fdc5abca790010f727b662b83ce24b9",
    "limits/resnet50-vis.slides.json":
        "0ecad2a2fe2ae716489cb5da4ac1cf0134360004d3ad6f658fab7562c146554b",
    "limits/resnet50-vis.train.json":
        "9040b17d5a3df1ae64da54ff4732fae6014d13eef40af820e93764755e24a9bc",
    "limits/uni-vis.slides.json":
        "0e2fb051a0e2f77911be0755bf31b4f49870b53e9b0548bd57f2f1e45184cd20",
    "metrics/backbone_ms_per_kpatch.py":
        "7cb7115629efffdb4aef5d2358b973ec18cddc7014a682551b9bab45fd83790c",
    "metrics/backbone_roofline_pct.py":
        "fdb23358a8f35d2bfbcc009156c23fc0d9f0e314f9fee3f76492b653db63e973",
    "metrics/device_idle_pct.infer.py":
        "162bc00ca0f0d9eec5c097e351126ecd7d28a53fe9bb889ca4d2d971bc1a3302",
    "metrics/device_idle_pct.train.py":
        "50519f4bea52a2e00a38aeacbb4372e9b92489481cdfac47f336f920b5c534fa",
    "metrics/eval_share_pct.train.py":
        "437d8a4d99e3cc7339de3efa65819ce130df4c7b3ecf320b207fa1feb2390374",
    "metrics/folds_ms_per_slide.py":
        "8aaa00902a5eccf3d109c1826c8d1060697a9730ad2719ee0769b3f0fac0459f",
    "metrics/folds_roofline_pct.py":
        "fb7d89ac58fee8332e7767e9d23ee0d04bf3247c357054a3626501f332c94880",
    "metrics/h2d_ms_per_slide.py":
        "5a66eae11ddf6b5e7e13ec3e4ad093fa4eb697e3cf2945fd0e91c0f6ca411def",
    "metrics/kmeans_ms_per_slide.py":
        "04d1eeb0c133a68c2de8d96129526fe5aefa77a63a27944a601e68ad0f3fe2b9",
    "metrics/kmeans_roofline_pct.py":
        "de502fad96fdb51c365ce2bb107c1f7fb475210b59f14a10ea2aeb134ae95ea5",
    "metrics/mfu_pct.infer.py":
        "ab949f2e8e05d05a55f7945c6c114b4fc837a7d6922b1dc8cf4a8eb35aef7b98",
    "metrics/mfu_pct.train.py":
        "0519f693e085450c3846aad077e914280872a8526949d92c14f46b04c500ac80",
    "reference/__init__.py":
        "da5687735cbb664492a16b81511b3a6c249f60a7cc90a3c5f97870da1e9881b0",
    "reference/kmeans.py":
        "2962256ec9128f57dd814532c1bfdd8d8f3fb72d6cb6d8490fe0bed1bec3cc4d",
    "reference/numerics.py":
        "f1470da97951a32867c3d51d54d53a6ca26fd13998851b55300d903810c4de80",
    "reference/resnet50.py":
        "8901a4a92e94cc7aee10771809e02794918f5f10edd455b024f5a91e9dcda79f",
    "reference/train.py":
        "a7aa5730791a561578e36a88138766cae5298bdfa78ca0a8b4e0dadf4753d1cf",
    "reference/uni_vitl16.py":
        "b7e1f1155b620e19dae64e392a94199c78f5e0c792f54acd1d4f6e40d214490b",
    "reference/vis.py":
        "48e307b0de8d7f8cf125919b119181235ba86edaac1880c96f01f3783edd3fb0",
    "run.py":
        "ecef4ff31793f483aca45487495cc89d0d374be609a649d6cef68f7f7401c495",
    "serving.py":
        "389a888f2a1662463d48c45e176c7befad0857e5981855be6f8ed82d8a1f9ef9",
    "tests/test_benchmark_arith.py":
        "b35228ab675c82e5e96304c54bccc454cc52cc084d619d5458471dd81dfd96aa",
    "tests/test_benchmark_control.py":
        "2b83afa6ad9c6b651220329ab7ded5625c04a8ddb66079dc1f17906f804fd8ab",
    "tests/test_benchmark_entries.py":
        "e0b2970b77d705e43a45d47f9c840dde9fb26ae5ce4c62158922e83db0a7fe85",
    "tests/test_benchmark_extend.py":
        "b50a6b10920a5c969b9ee194c9e75336d3854433789bcc840d01ccc363a7611b",
    "tests/test_benchmark_faults.py":
        "4b6b34a29536da877846dc91acf38c5312c7c50ea216a9f906a1371c4595fc65",
    "tests/test_benchmark_metrics.py":
        "b897ec869ce509936deb3cfcae3a49d435635b78963cbb35cc2c76a1cd113fc7",
    "tests/test_benchmark_schema.py":
        "ff77f2f33a4959a70a15520b7585b36a389eb4f4fd993a25eb6b700d091b5417",
    "tests/tiny.py":
        "a298c97a85345ba86b9e459dafbe63b4295a3dbb0760b49049a4341179c4b94a",
    "trace.py":
        "4b60641fb33ce794988294443bb656e8ae35935df86bbf4c7ab330e4ae069130",
    "traffic/features.json":
        "272057cfcb2367adab72b5ade54ffb07cc49f2a1c77c591e93e9df0d84e67c45",
    "traffic/slides.json":
        "4bdd09f6771a2546b2e286f1587007dc95303e2758dbfed271a7b084cd88acad",
    "traffic/train.json":
        "fc13aee601478c6e1eb0c77fa48b0f4e1998921928172078937adf5f72caea0e",
    "weights.py":
        "50f138e02c0e0ce03e5fab75904ee9740abb03cfcac0acb563f8a8112666e695",
}


def canned_summary():
    """Four slides: seeding 100 ms of device time, Lloyd 30 ms over 60 steps,
    250 host syncs; 10 training steps issued in 250 host ms, 12 waits of
    6 ms in all."""
    def s(count, host, device):
        return {"count": count, "host_ms": host, "self_host_ms": host, "device_ms": device}
    return {"spans": {"serve.kmeans": s(4, 260.0, 240.0), "kmeans.seed": s(4, 90.0, 100.0),
                      "kmeans.lloyd": s(4, 40.0, 30.0), "train.step": s(10, 250.0, 300.0),
                      "train.batch_wait": s(12, 6.0, 6.0)},
            "counters": {"kmeans.lloyd_steps": 60, "host_syncs": 250}}


@pytest.mark.parametrize("name, value", [
    ("kmeans_seed_ms_per_slide", 25.0), ("lloyd_ms_per_step", 0.5),
    ("lloyd_steps_per_slide", 15.0), ("host_syncs_per_slide", 62.5),
    ("step_host_ms.train", 25.0), ("batch_wait_ms.train", 0.5)])
def test_reader_known_value(monkeypatch, name, value):
    monkeypatch.setattr(profiling, "summary", canned_summary)
    assert run.reader(common.ROOT, name).read({"trace": {"window_s": 1.0}}) == \
        pytest.approx(value)


@pytest.mark.parametrize("name", SERVING + TRAIN)
def test_reader_of_a_program_without_the_recorder_is_none(monkeypatch, name):
    monkeypatch.delattr(profiling, "summary")
    assert run.reader(common.ROOT, name).read({"trace": {"window_s": 1.0}}) is None
    monkeypatch.undo()
    profiling.clear()
    assert run.reader(common.ROOT, name).read({"trace": {"window_s": 1.0}}) is None


@pytest.mark.parametrize("workload, names", [("resnet50-vis.features", SERVING),
                                             ("resnet50-vis.train", TRAIN)])
def test_traced_cpu_run_reports_them(workload, names):
    profiling.clear()
    result, _ = run.run_cell(tiny.spec(workload), seed=2 ** 31 + 11, seconds=0.5, trace=True,
                             device=torch.device("cpu"), t_start=time.perf_counter())
    profiling.clear()
    for name in names:
        assert result["metrics"][name]["value"] > 0, name
    assert result["correct"]


def test_files_that_were_there_are_unchanged():
    now = digest(common.ROOT)
    assert {k: now.get(k) for k in BEFORE} == BEFORE
