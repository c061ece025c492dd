"""How the kernels' keys build (ops.cuda_spec.prebuild, ops.cuda_build)
on the CPU: several keys that share a header's defines go into one
translation unit, each instantiation in a namespace of its own, and
each key finds its own kernel's -Xptxas -v lines in the unit's log by
the kernel's mangled name.  The names below are g++'s Itanium manglings
of the kernels' template signatures (the names nvcc gives the kernels
differ only in the anonymous namespace's prefix).  The builds
themselves run only on a CUDA card (tests/test_torch_cuda.py)."""

import pytest
import torch

from rayopt_tpu_torch import set_default_device
from rayopt_tpu_torch.models import double_gauss
from rayopt_tpu_torch.ops import cuda_build as CB
from rayopt_tpu_torch.ops import cuda_spec as CS
from rayopt_tpu_torch.ops import df32 as D
from rayopt_tpu_torch.ops.kernels import specialize

F32, F64 = torch.float32, torch.float64
#: (mangled name, the key whose kernel it names)
MANGLED = [
    ("_ZN12_GLOBAL__N_110trace_specIfNS_5ChainIJLx5ELxn7ELx4611686018427387"
     "904EEEELb0ELi512ELi2EEEvPKT_PS3_l",
     CS.Key("k1", "f32", (5, -7, 1 << 62), False, False, 512, 2)),
    ("_ZN12_GLOBAL__N_112moments_specIdNS_5ChainIJLx1ELx2EEEELb1ELb0ELi3ELi"
     "256ELi2EEEvPKT_Pjl",
     CS.Key("k3m", "f64", (1, 2), True, False, 256, 2, nlam=3)),
    ("_ZN12_GLOBAL__N_116trace_multi_specIdNS_5ChainIJLx1ELx2EEEELb1ELi3ELi"
     "512ELi1EEEvPKT_PS3_l",
     CS.Key("k3", "f64", (1, 2), False, False, 512, 1, nlam=3, outer=True)),
    ("_ZN12_GLOBAL__N_124merit_adjoint_multi_specIfNS_5ChainIJLx9EEEELb0ELb1"
     "ELi128ELi1EEEvPKT_PS3_l",
     CS.Key("k7", "f32", (9,), False, True, 128, 1)),
    ("_ZN12_GLOBAL__N_115df32_trace_specINS_5PlansIJNS_4PlanIJLx1ELx2EEEENS2"
     "_IJLx3ELxn4EEEEEEENS_7PlanMapIJLi0ELi1ELi1EEEELb1ELi1ELi128ELi1EEEvNS_"
     "11KernelWordsIT_T0_XT2_EEENS_4In12EPfl",
     CS.Df32Key("k11", ((1, 2), (3, -4)), (0, 1, 1), True, 128, 1,
                staged=True)),
    ("_ZN12_GLOBAL__N_115df32_merit_specINS_5PlansIJNS_4PlanIJLx7EEEEEEENS_7"
     "PlanMapIJLi0EEEELi0ELi256ELi2EEEvNS_11KernelWordsIT_T0_XT1_EEENS_4In12"
     "EPfPjPdl",
     CS.Df32Key("k13", ((7,),), (0,), False, 256, 2)),
]


@pytest.fixture(autouse=True)
def _cpu_default():
    old = set_default_device("cpu")
    yield
    set_default_device(old)


@pytest.mark.parametrize("entry,key", MANGLED,
                         ids=[k.kernel for _, k in MANGLED])
def test_a_kernels_mangled_name_spells_its_keys_template_arguments(entry,
                                                                    key):
    assert CS.entry_args(entry) == CS.template_args(key)
    # nvcc's anonymous namespace has a longer name of its own
    nvcc = entry.replace("12_GLOBAL__N_1",
                         "40_INTERNAL_3f2a_12_g8_0a1b_cu_9e1d2c3b")
    assert CS.entry_args(nvcc) == CS.template_args(key)
    # any other key of the same kind reads differently
    other = key._replace(block=key.block // 2)
    assert CS.entry_args(entry) != CS.template_args(other)
    assert CS.entry_args("_Z6kernelPf") is None


def test_a_units_log_is_cut_by_kernel():
    log = ("ptxas info    : 0 bytes gmem\n"
           "ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1aPf\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 32 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z1bPd' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1bPd\n"
           "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 80 registers, used 1 barriers\n")
    head, blocks = CB.entry_reports(log)
    assert head == "ptxas info    : 0 bytes gmem\n"
    assert list(blocks) == ["_Z1aPf", "_Z1bPd"]
    assert "Used 32 registers" in blocks["_Z1aPf"]
    assert "80" not in blocks["_Z1aPf"]
    assert "8 bytes stack frame" in blocks["_Z1bPd"]


def test_keys_with_the_same_defines_share_a_unit():
    """The double Gauss's K1, K2 and K5 keys (no defines) and its df32
    plan's K10 and K12 keys: one unit a header at `most` keys or more,
    each instantiation in its key's namespace, the defines and the
    include once."""
    s = double_gauss()
    specs = specialize(s.table())
    spec_keys = [CS.trace_key(specs, F32, False), CS.trace_key(specs, F64),
                 CS.merit_key(specs, F64, True),
                 CS.adjoint_key(specs, F64, False, ("curvature",), False)]
    plan = D.plan(s.table(), fast=True)
    df32_keys = [CS.df32_multi_key([plan], "k11", True),
                 CS.df32_multi_key([plan], "k13")]
    units = CS._group_units(spec_keys + df32_keys, 8)
    assert sorted(len(keys) for _, keys in units.values()) == [2, 4]
    for text, keys in units.values():
        header = ("grad_spec.cuh" if keys[0] in spec_keys
                  else "df32_spec.cuh")
        assert text.count('#include "%s"' % header) == 1
        assert text.count("#include") == 1
        for k in keys:
            alone = CS.translation_unit(k)
            body = alone[alone.index("\n", alone.index("#include")) + 1:]
            assert "namespace unit_%s {\n%s}" % (k.name, body) in text
    split = CS._group_units(spec_keys, 3)
    assert sorted(len(keys) for _, keys in split.values()) == [1, 3]
    assert len({name for name in split} | set(units)) == 4
