"""The port's config system (``mmr_tpu_torch/config/config.py``) held
against the JAX package's ``mmr_tpu/config/config.py``: the default schema,
``safe_eval``, the override grammar with its errors, ``get_config``'s
three modes, and the stdlib YAML writer and reader against PyYAML both
ways (PyYAML is allowed in tests, not in the port)."""

import math

import pytest
import yaml

import mmr_tpu.config.config as jc
import mmr_tpu_torch.config.config as pc
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401


@pytest.mark.parametrize("n_classes, patch", [(9, (512, 640)), (2, [32, 32])])
def test_default_config_matches_jax(n_classes, patch):
    got, want = pc.get_default_config(n_classes, patch), jc.get_default_config(n_classes, patch)
    assert got == want and list(got) == list(want)
    assert list(got["transformations"]) == list(want["transformations"])


@pytest.mark.parametrize("text", ["16", "1e-3", "true", "False", "none", "NULL",
                                  "[512, 640]", "resnet18", "(1, 2)", "{'a': 1}",
                                  " 0.5", "-3", "tu-mobilenetv3_small_100", "1.0.0"])
def test_safe_eval_matches_jax(text):
    assert pc.safe_eval(text) == jc.safe_eval(text)
    assert type(pc.safe_eval(text)) is type(jc.safe_eval(text))


@pytest.mark.parametrize("args, mode", [
    (["--batch_size", "16", "--optimizer_lr", "0.001", "--model_arch", "Unet",
      "--transformations_rotation", "false", "--lr_scheduler_total_iters", "50"],
     "training"),
    (["--transformations_per_sample_spatial", "true", "--oversample_strategy",
      "probabilistic", "--transformations_dummy_2d", "true"], "training"),
    (["--mesh_data", "2", "--seed", "1", "--profile_epochs", "[1, 2]",
      "--model_encoder_name", "resnet18", "--optimizer_name", "SGD"], "training"),
    (["--sw_overlap", "0.75", "--sw_chunked", "True"], "testing"),
    (["--n_epochs", "5"], "continue_training"),
    (None, "training"),
    ([], "testing"),
    (["--nonsense", "1"], "training"),
    (["--batch_size", "4"], "testing"),
    (["--batch_size"], "training"),
])
def test_override_grammar_matches_jax(args, mode):
    def run(mod):
        try:
            return "ok", mod.check_and_convert_user_config_args(args, mode)
        except (KeyError, ValueError) as e:
            return type(e).__name__, str(e)

    got, want = run(pc), run(jc)
    assert got == want


@pytest.mark.parametrize("config_args", [None, {"n_epochs": 55},
                                         {"optimizer": {"lr": 0.5}, "batch_size": 3}])
def test_add_user_config_args_matches_jax(config_args):
    got = pc.add_user_config_args(pc.get_default_config(3, [64, 64]), config_args)
    assert got == jc.add_user_config_args(jc.get_default_config(3, [64, 64]), config_args)


def test_get_config_modes_match_jax(tmp_path):
    """Each side in its own results directory: the same returned configs
    in every mode, the same refusals; the port's config.yaml reads back
    through PyYAML to the returned config."""
    def modes(mod, res):
        ds = tmp_path / "ds"
        out = [mod.get_config(str(ds), str(res), "training",
                              config_args={"batch_size": 2, "n_epochs": 3},
                              n_classes=3, patch_size=[64, 64], progress_bar=True)]
        out.append(mod.get_config(str(ds), str(res), "continue_training"))
        with pytest.raises(AssertionError):
            mod.get_config(str(ds), str(res), "continue_training",
                           config_args={"batch_size": 7})
        out.append(mod.get_config(str(ds), str(res), "testing",
                                  config_args={"sw_overlap": 0.75}))
        with pytest.raises(FileNotFoundError):
            mod.get_config(str(ds), str(tmp_path / "nope"), "testing")
        with pytest.raises(ValueError):
            mod.get_config(str(ds), str(res), "bogus_mode")
        return out

    got, want = modes(pc, tmp_path / "res"), modes(jc, tmp_path / "jres")
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        for d in (g, w):
            d.pop("results_path")
            if d["load_model_path"]:
                d["load_model_path"] = d["load_model_path"].rsplit("/", 1)[1]
        assert g == w
    text = (tmp_path / "res" / "config.yaml").read_text()
    assert yaml.safe_load(text) == {**want[0], "results_path": str(tmp_path / "res")}


def _odd_config():
    cfg = pc.get_default_config(9, (512, 640))
    cfg.update(results_path="/tmp/a b/run-1", tiny=1e-05, big=1e20, word="true",
               empty="", nothing=None, mixed=[1, 2.5, "a", None, True, "yes"],
               no_list=[], no_map={}, neg=-3, inf=math.inf, ninf=-math.inf,
               quote="it's", hexish="0x10", colon="a:b", deep={"a": {"b": {"c": 0.5}}},
               profile_epochs=[1, 2])
    return cfg


def test_yaml_writer_is_read_by_pyyaml():
    cfg = _odd_config()
    text = pc.dump_yaml(cfg)
    assert yaml.safe_load(text) == cfg
    assert pc.load_yaml(text) == cfg
    # the default config is written byte for byte as JAX's PyYAML dumper does
    default = pc.get_default_config(9, (512, 640))
    assert pc.dump_yaml(default) == yaml.dump(default, Dumper=jc._FlowListDumper,
                                              sort_keys=False)


def test_yaml_reader_reads_jax_create_config(tmp_path):
    cfg = _odd_config()
    for k in ("quote",):   # PyYAML writes it's plain: outside the subset
        cfg.pop(k)
    path = jc.create_config(cfg, tmp_path)
    assert pc.read_config(path) == cfg
    nested = pc.read_config(path)["deep"]
    assert nested == {"a": {"b": {"c": 0.5}}}
    assert math.isnan(pc.load_yaml("x: .nan\n")["x"])
    assert pc.load_yaml("a: 1  # note\nb:\nc: 'x # y'\n") == {"a": 1, "b": None,
                                                             "c": "x # y"}
    assert pc.load_yaml("") is None


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n", "a: &x 1\n", "a: *x\n", "a: !!str 1\n", "a: 012\n", "a: 1:30\n",
    "a: 0x1F\n", "a: 1_000\n", "a: |\n  x\n", "a: >\n  x\n", "a: [1, [2]]\n",
    "a: [1,\n  2]\n", "a: {b: 1}\n", "a: 1\na: 2\n", "a: 2001-01-01\n", "a: 'x\n",
    " a: 1\nb: 2\n", "a: 1e5\n", "a\n", "a: b: c\n", "a:\n    b: 1\n  c: 2\n",
    "a: [1,]\n", "---\na: 1\n", "a:\n\t- 1\n", "a: it's\n", "a: x\n  y\n",
])
def test_yaml_reader_refuses_outside_the_subset(text):
    with pytest.raises(ValueError, match=r"line \d+"):
        pc.load_yaml(text)


def test_yaml_writer_refuses_outside_the_subset():
    for bad in ({"a": [[1]]}, {"a": [{"b": 1}]}, {1: 2}, {"a": object()}, [1]):
        with pytest.raises(ValueError):
            pc.dump_yaml(bad)


@pytest.mark.parametrize("name", [None, "bf16", "bfloat16", "amp", "fp16", "half",
                                  "mixed", "fp32", "float32", "full", "int8", "FP32"])
def test_precision_matches_jax(name):
    import torch

    import mmr_tpu.core.precision as jp
    import mmr_tpu_torch.core.precision as pp

    try:
        want = jp.resolve(name).compute_dtype.__name__
    except ValueError:
        with pytest.raises(ValueError, match="unknown precision"):
            pp.resolve(name)
        return
    got = pp.resolve(name)
    assert {"bfloat16": torch.bfloat16, "float32": torch.float32}[want] == got.compute_dtype
    assert got.param_dtype == got.output_dtype == torch.float32
    cast = got.cast_compute({"a": torch.ones(2), "b": [torch.ones(1, dtype=torch.int64)]})
    assert cast["a"].dtype == got.compute_dtype and cast["b"][0].dtype == torch.int64
