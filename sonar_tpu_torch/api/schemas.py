"""Reference node parameter schemas — GENERATED, do not edit.

Regenerate with:
    python -m sonar_tpu_torch.api._gen_schemas

One entry per reference node (py/nodes/* NODE_CLASS_MAPPINGS), one
field spec per widget/input. Field spec keys:
    t   - kind: f(float) i(int) b(bool) s(string) enum tri dyn x(link)
    d   - widget default
    lo/hi - numeric range
    opts  - static enum options
    dom   - dynamic domain name resolved against live registries
            (see sonar_tpu_torch.api.validate.DOMAINS); extras are
            additionally-allowed literals (e.g. 'DEFAULT')
    ty  - declared link type for object inputs
    r   - 1 if the reference declares the field required
"""

SCHEMAS = {
 "FreeUExtreme": {
  "cpu_fft": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "input_config": {
   "t": "x",
   "ty": "FRUX_CONFIG"
  },
  "middle_config": {
   "t": "x",
   "ty": "FRUX_CONFIG"
  },
  "model": {
   "r": 1,
   "t": "x",
   "ty": "MODEL"
  },
  "output_config": {
   "t": "x",
   "ty": "FRUX_CONFIG"
  }
 },
 "FreeUExtremeConfig": {
  "blend": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "blend_mode": {
   "d": "lerp",
   "dom": "blend",
   "r": 1,
   "t": "dyn"
  },
  "end": {
   "d": 1.0,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "filter_norm": {
   "d": 0.0,
   "hi": 10.0,
   "lo": -10.0,
   "r": 1,
   "t": "f"
  },
  "final": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "frux_config_opt": {
   "t": "x",
   "ty": "FRUX_CONFIG"
  },
  "hidden_mean": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "scale": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "slice": {
   "d": 1.0,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "slice_offset": {
   "d": 0.0,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_power_filter_opt": {
   "t": "x",
   "ty": "SONAR_POWER_FILTER"
  },
  "stage_1": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "stage_2": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "stage_3": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "start": {
   "d": 0.0,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "target": {
   "d": "backbone",
   "opts": [
    "backbone",
    "skip",
    "both"
   ],
   "r": 1,
   "t": "enum"
  }
 },
 "KRestartSamplerCustomNoise": {
  "add_noise": {
   "d": "enable",
   "opts": [
    "enable",
    "disable"
   ],
   "r": 1,
   "t": "enum"
  },
  "cfg": {
   "d": 8.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "chunked_mode": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "end_at_step": {
   "d": 10000,
   "hi": 10000,
   "lo": 0,
   "r": 1,
   "t": "i"
  },
  "latent_image": {
   "r": 1,
   "t": "x",
   "ty": "LATENT"
  },
  "model": {
   "r": 1,
   "t": "x",
   "ty": "MODEL"
  },
  "negative": {
   "r": 1,
   "t": "x",
   "ty": "CONDITIONING"
  },
  "noise_seed": {
   "d": 0,
   "hi": 18446744073709551615,
   "lo": 0,
   "r": 1,
   "t": "i"
  },
  "positive": {
   "r": 1,
   "t": "x",
   "ty": "CONDITIONING"
  },
  "restart_scheduler": {
   "d": None,
   "dom": "any_str",
   "r": 1,
   "t": "dyn"
  },
  "return_with_leftover_noise": {
   "d": "disable",
   "opts": [
    "disable",
    "enable"
   ],
   "r": 1,
   "t": "enum"
  },
  "sampler": {
   "r": 1,
   "t": "x",
   "ty": "SAMPLER"
  },
  "scheduler": {
   "d": None,
   "dom": "any_str",
   "r": 1,
   "t": "dyn"
  },
  "segments": {
   "d": "",
   "r": 1,
   "t": "s"
  },
  "start_at_step": {
   "d": 0,
   "hi": 10000,
   "lo": 0,
   "r": 1,
   "t": "i"
  },
  "steps": {
   "d": 20,
   "hi": 10000,
   "lo": 1,
   "r": 1,
   "t": "i"
  }
 },
 "NoisyLatentLike": {
  "add_to_latent": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "cpu_noise": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "latent": {
   "r": 1,
   "t": "x",
   "ty": "LATENT"
  },
  "model_opt": {
   "t": "x",
   "ty": "MODEL"
  },
  "mul_by_sigmas_opt": {
   "t": "x",
   "ty": "SIGMAS"
  },
  "multiplier": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "noise_type": {
   "d": "gaussian",
   "dom": "noise_type",
   "r": 1,
   "t": "dyn"
  },
  "normalize": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "repeat_batch": {
   "d": 1,
   "hi": 10000,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "seed": {
   "d": 0,
   "hi": 18446744073709551615,
   "lo": 0,
   "r": 1,
   "t": "i"
  }
 },
 "RestartSamplerCustomNoise": {
  "chunked_mode": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "sampler": {
   "r": 1,
   "t": "x",
   "ty": "SAMPLER"
  }
 },
 "SONAR_CUSTOM_NOISE to NOISE": {
  "cpu_noise": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "multiplier": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "normalize": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "seed": {
   "d": 0,
   "hi": 18446744073709551615,
   "lo": 0,
   "r": 1,
   "t": "i"
  }
 },
 "SamplerConfigOverride": {
  "cpu_noise": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "eta": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "noise_type": {
   "d": "DEFAULT",
   "dom": "noise_type",
   "extras": [
    "DEFAULT"
   ],
   "t": "dyn"
  },
  "normalize": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "r": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "s_churn": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "s_noise": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "sampler": {
   "r": 1,
   "t": "x",
   "ty": "SAMPLER"
  },
  "sde_solver": {
   "d": None,
   "opts": [
    "midpoint",
    "heun"
   ],
   "r": 1,
   "t": "enum"
  },
  "yaml_parameters": {
   "t": "s"
  }
 },
 "SamplerSonarDPMPPSDE": {
  "custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "direction": {
   "d": 1.0,
   "hi": 15.0,
   "lo": -30.0,
   "r": 1,
   "t": "f"
  },
  "eta": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "guidance_cfg_opt": {
   "t": "x",
   "ty": "SONAR_GUIDANCE_CFG"
  },
  "momentum": {
   "d": 0.95,
   "hi": 2.5,
   "lo": -0.5,
   "r": 1,
   "t": "f"
  },
  "momentum_hist": {
   "d": 0.75,
   "hi": 1.5,
   "lo": -1.5,
   "r": 1,
   "t": "f"
  },
  "momentum_init": {
   "d": "ZERO",
   "opts": [
    "ZERO",
    "RAND",
    "SAMPLE",
    "SAMPLE_NORM"
   ],
   "r": 1,
   "t": "enum"
  },
  "noise_type": {
   "d": "brownian",
   "dom": "noise_type",
   "r": 1,
   "t": "dyn"
  },
  "rand_init_noise_type": {
   "d": "gaussian",
   "dom": "noise_type",
   "r": 1,
   "t": "dyn"
  },
  "s_noise": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  }
 },
 "SamplerSonarEuler": {
  "direction": {
   "d": 1.0,
   "hi": 15.0,
   "lo": -30.0,
   "r": 1,
   "t": "f"
  },
  "guidance_cfg_opt": {
   "t": "x",
   "ty": "SONAR_GUIDANCE_CFG"
  },
  "momentum": {
   "d": 0.95,
   "hi": 2.5,
   "lo": -0.5,
   "r": 1,
   "t": "f"
  },
  "momentum_hist": {
   "d": 0.75,
   "hi": 1.5,
   "lo": -1.5,
   "r": 1,
   "t": "f"
  },
  "momentum_init": {
   "d": "ZERO",
   "opts": [
    "ZERO",
    "RAND",
    "SAMPLE",
    "SAMPLE_NORM"
   ],
   "r": 1,
   "t": "enum"
  },
  "rand_init_noise_type": {
   "d": "gaussian",
   "dom": "noise_type",
   "r": 1,
   "t": "dyn"
  }
 },
 "SamplerSonarEulerA": {
  "custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "direction": {
   "d": 1.0,
   "hi": 15.0,
   "lo": -30.0,
   "r": 1,
   "t": "f"
  },
  "eta": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "guidance_cfg_opt": {
   "t": "x",
   "ty": "SONAR_GUIDANCE_CFG"
  },
  "momentum": {
   "d": 0.95,
   "hi": 2.5,
   "lo": -0.5,
   "r": 1,
   "t": "f"
  },
  "momentum_hist": {
   "d": 0.75,
   "hi": 1.5,
   "lo": -1.5,
   "r": 1,
   "t": "f"
  },
  "momentum_init": {
   "d": "ZERO",
   "opts": [
    "ZERO",
    "RAND",
    "SAMPLE",
    "SAMPLE_NORM"
   ],
   "r": 1,
   "t": "enum"
  },
  "noise_type": {
   "d": "gaussian",
   "dom": "noise_type",
   "r": 1,
   "t": "dyn"
  },
  "rand_init_noise_type": {
   "d": "gaussian",
   "dom": "noise_type",
   "r": 1,
   "t": "dyn"
  },
  "s_noise": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  }
 },
 "SonarAdvanced1fNoise": {
  "alpha": {
   "d": 0.25,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "horizontal_factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "k": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "use_sqrt": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "vertical_factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  }
 },
 "SonarAdvancedCollatzNoise": {
  "add_preserves_sign": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "adjust_scale": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "break_loops": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "chain_length": {
   "d": "1, 1, 2, 2, 3, 3",
   "r": 1,
   "t": "s"
  },
  "chain_offset": {
   "d": 5,
   "hi": 10000,
   "lo": 0,
   "r": 1,
   "t": "i"
  },
  "dims": {
   "d": "-1, -1, -2, -2",
   "r": 1,
   "t": "s"
  },
  "even_addition": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "even_multiplier": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "flatten": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "integer_math": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "iteration_sign_flipping": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "iterations": {
   "d": 10,
   "hi": 10000,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "mix_custom_noise": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "noise_dtype": {
   "d": "float32",
   "opts": [
    "float32",
    "float64",
    "float16",
    "bfloat16"
   ],
   "r": 1,
   "t": "enum"
  },
  "odd_addition": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "odd_multiplier": {
   "d": 3.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "output_mode": {
   "d": "values",
   "opts": [
    "values",
    "ratios",
    "mults",
    "adds",
    "seed_x_mults",
    "seed_x_adds",
    "noise_x_ratios",
    "noise_x_mults",
    "noise_x_adds"
   ],
   "r": 1,
   "t": "enum"
  },
  "quantile": {
   "d": 0.5,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "quantile_strategy": {
   "d": "clamp",
   "dom": "quantile_strategy",
   "r": 1,
   "t": "dyn"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "rmax": {
   "d": 8000.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "rmin": {
   "d": -8000.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "seed_custom_noise": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "seed_mode": {
   "d": "default",
   "opts": [
    "default",
    "force_odd",
    "force_even"
   ],
   "r": 1,
   "t": "enum"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarAdvancedDistroNoise": {
  "beta_concentration0": {
   "d": "0.5",
   "r": 1,
   "t": "s"
  },
  "beta_concentration1": {
   "d": "0.5",
   "r": 1,
   "t": "s"
  },
  "cauchy_median": {
   "d": "0.0",
   "r": 1,
   "t": "s"
  },
  "cauchy_sigma": {
   "d": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "continuous_bernoulli_probs": {
   "d": "0.5",
   "r": 1,
   "t": "s"
  },
  "dirichlet_concentration": {
   "d": "0.5 0.5",
   "r": 1,
   "t": "s"
  },
  "distribution": {
   "d": "uniform",
   "dom": "distro",
   "r": 1,
   "t": "dyn"
  },
  "exponential_lambd": {
   "d": 1.0,
   "r": 1,
   "t": "f"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "fisher_snedecor_df1": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "fisher_snedecor_df2": {
   "d": "2.0",
   "r": 1,
   "t": "s"
  },
  "gamma_concentration": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "gamma_rate": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "geometric_p": {
   "d": 0.25,
   "r": 1,
   "t": "f"
  },
  "gumbel_loc": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "gumbel_scale": {
   "d": "2.0",
   "r": 1,
   "t": "s"
  },
  "inverse_gamma_concentration": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "inverse_gamma_rate": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "kumaraswamy_concentration0": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "kumaraswamy_concentration1": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "laplacian_loc": {
   "d": "0.0",
   "r": 1,
   "t": "s"
  },
  "laplacian_scale": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "lkjcholesky_concentration": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "lkjcholesky_dim": {
   "d": 3,
   "r": 1,
   "t": "i"
  },
  "log_normal_mean": {
   "d": 1.0,
   "r": 1,
   "t": "f"
  },
  "log_normal_std": {
   "d": 2.0,
   "r": 1,
   "t": "f"
  },
  "lrmvariate_normal_cov_diag": {
   "d": "1.0 1.0",
   "r": 1,
   "t": "s"
  },
  "lrmvariate_normal_cov_factor": {
   "d": "1.0 0.0",
   "r": 1,
   "t": "s"
  },
  "lrmvariate_normal_loc": {
   "d": "0.0 0.0",
   "r": 1,
   "t": "s"
  },
  "mvariate_normal_cov_multiplier": {
   "d": 1.0,
   "r": 1,
   "t": "f"
  },
  "mvariate_normal_loc": {
   "d": "0.0 0.0",
   "r": 1,
   "t": "s"
  },
  "normal_mean": {
   "d": 0.0,
   "r": 1,
   "t": "f"
  },
  "normal_std": {
   "d": 1.0,
   "r": 1,
   "t": "f"
  },
  "pareto_alpha": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "pareto_scale": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "poisson_rate": {
   "d": "1.5",
   "r": 1,
   "t": "s"
  },
  "quantile_norm": {
   "d": 0.85,
   "hi": 1.0,
   "lo": -1.0,
   "r": 1,
   "t": "f"
  },
  "quantile_norm_mode": {
   "d": "batch",
   "opts": [
    "global",
    "batch",
    "channel",
    "batch_row",
    "batch_col",
    "nonflat_row",
    "nonflat_col"
   ],
   "r": 1,
   "t": "enum"
  },
  "relaxed_bernoulli_probs": {
   "d": "0.66",
   "r": 1,
   "t": "s"
  },
  "relaxed_bernoulli_temperature": {
   "d": 0.75,
   "r": 1,
   "t": "f"
  },
  "relaxed_onehotcategorical_probs": {
   "d": "0.33 0.66",
   "r": 1,
   "t": "s"
  },
  "relaxed_onehotcategorical_temperature": {
   "d": 1.5,
   "r": 1,
   "t": "f"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "result_index": {
   "d": "-1",
   "r": 1,
   "t": "s"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "studentt_df": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "studentt_loc": {
   "d": "0.0",
   "r": 1,
   "t": "s"
  },
  "studentt_scale": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "uniform_high": {
   "d": 1.0,
   "r": 1,
   "t": "f"
  },
  "uniform_low": {
   "d": 0.0,
   "r": 1,
   "t": "f"
  },
  "vonmises_concentration": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "vonmises_loc": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "weibull_concentration": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "weibull_scale": {
   "d": "1.0",
   "r": 1,
   "t": "s"
  },
  "wishart_cov_multiplier": {
   "d": 1.0,
   "r": 1,
   "t": "f"
  },
  "wishart_cov_size": {
   "d": 2,
   "r": 1,
   "t": "i"
  },
  "wishart_df": {
   "d": "2.0",
   "r": 1,
   "t": "s"
  }
 },
 "SonarAdvancedPowerLawNoise": {
  "alpha": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "div_max_dims": {
   "d": "non-batch",
   "opts": [
    "none",
    "non-batch",
    "spatial",
    "all",
    "batch",
    "channel",
    "height",
    "width"
   ],
   "r": 1,
   "t": "enum"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "use_div_max_abs": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "use_sign": {
   "d": False,
   "r": 1,
   "t": "b"
  }
 },
 "SonarAdvancedPyramidNoise": {
  "discount": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "iterations": {
   "d": -1,
   "hi": 8,
   "lo": -1,
   "r": 1,
   "t": "i"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "upscale_mode": {
   "d": "default",
   "dom": "scale",
   "extras": [
    "default"
   ],
   "r": 1,
   "t": "dyn"
  },
  "variant": {
   "d": "highres_pyramid",
   "opts": [
    "highres_pyramid",
    "pyramid",
    "pyramid_old"
   ],
   "r": 1,
   "t": "enum"
  }
 },
 "SonarAdvancedVoronoiNoise": {
  "custom_noise": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "distance_mode": {
   "d": "euclidean",
   "r": 1,
   "t": "s"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "gain": {
   "d": 0.75,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "initial_amplitude": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "initial_scale": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "lacunarity": {
   "d": 2.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "n_points": {
   "d": "256",
   "r": 1,
   "t": "s"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "octave_mode": {
   "d": "new_features",
   "opts": [
    "same_features",
    "new_features",
    "same_invert_odd",
    "same_invert_even",
    "same_roll_chan_up",
    "same_roll_chan_down",
    "same_roll_dir_up",
    "same_roll_dir_down"
   ],
   "r": 1,
   "t": "enum"
  },
  "octaves": {
   "d": 3,
   "hi": 10000,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "result_mode": {
   "d": "diff2",
   "r": 1,
   "t": "s"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "z_increment": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "z_initial": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "z_max": {
   "d": 9999.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "z_max_mode": {
   "d": "reset",
   "opts": [
    "reset",
    "wrap",
    "bounce"
   ],
   "r": 1,
   "t": "enum"
  }
 },
 "SonarApplyLatentOperationCFG": {
  "blend_mode": {
   "d": "lerp",
   "dom": "blend",
   "r": 1,
   "t": "dyn"
  },
  "blend_scale_max": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "blend_scale_min": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "blend_scale_mode": {
   "d": "reverse_sampling",
   "opts": [
    "none",
    "reverse_sampling",
    "sampling",
    "reverse_enabled_range",
    "enabled_range",
    "sampling_sin",
    "enabled_range_sin"
   ],
   "r": 1,
   "t": "enum"
  },
  "blend_scale_offset": {
   "d": 0.0,
   "hi": 1.0,
   "lo": -1.0,
   "r": 1,
   "t": "f"
  },
  "blend_strength": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "end_sigma": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "immediate_blend": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "mode": {
   "d": "cond_sub_uncond",
   "opts": [
    "cond_sub_uncond",
    "denoised_sub_uncond",
    "uncond_sub_cond",
    "denoised",
    "cond",
    "uncond",
    "model_input"
   ],
   "r": 1,
   "t": "enum"
  },
  "model": {
   "r": 1,
   "t": "x",
   "ty": "MODEL"
  },
  "operation_1": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_2": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_3": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_4": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_5": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "pred_flip_mode": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "require_uncond": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "start_sigma": {
   "d": -1.0,
   "hi": 10000.0,
   "lo": -1.0,
   "r": 1,
   "t": "f"
  }
 },
 "SonarBlehOpsNoise": {
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "rules": {
   "r": 1,
   "t": "s"
  },
  "sonar_custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarBlendFilterNoise": {
  "affect": {
   "d": "result",
   "opts": [
    "result",
    "noise",
    "both"
   ],
   "r": 1,
   "t": "enum"
  },
  "blend_mode": {
   "d": "simple_add",
   "dom": "blend",
   "r": 1,
   "t": "dyn"
  },
  "enhance_mode": {
   "d": "none",
   "dom": "enhance",
   "extras": [
    "none"
   ],
   "r": 1,
   "t": "dyn"
  },
  "enhance_strength": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "ffilter": {
   "d": None,
   "dom": "ffilter",
   "r": 1,
   "t": "dyn"
  },
  "ffilter_custom": {
   "d": "",
   "r": 1,
   "t": "s"
  },
  "ffilter_scale": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "ffilter_strength": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "ffilter_threshold": {
   "d": 1,
   "hi": 32,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "normalize_noise": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "normalize_result": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "sonar_custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarBlendedNoise": {
  "blend_mode": {
   "d": "lerp",
   "dom": "blend",
   "r": 1,
   "t": "dyn"
  },
  "custom_noise_1": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "custom_noise_2": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "custom_noise_mask": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "noise_2_percent": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarChannelNoise": {
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "insufficient_channels_mode": {
   "d": "wrap",
   "opts": [
    "wrap",
    "repeat",
    "zero"
   ],
   "r": 1,
   "t": "enum"
  },
  "mix_count": {
   "d": 1,
   "hi": 100,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "sonar_custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarCompositeNoise": {
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "mask": {
   "r": 1,
   "t": "x",
   "ty": "MASK"
  },
  "normalize_dst": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "normalize_result": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "normalize_src": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "sonar_custom_noise_dst": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "sonar_custom_noise_src": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarCustomNoise": {
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "noise_type": {
   "d": "gaussian",
   "dom": "noise_type",
   "r": 1,
   "t": "dyn"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarCustomNoiseAdv": {
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "noise_type": {
   "d": "gaussian",
   "dom": "noise_type",
   "r": 1,
   "t": "dyn"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "yaml_parameters": {
   "t": "s"
  }
 },
 "SonarCustomNoiseParameters": {
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "ensure_square_aspect_ratio": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "fix_invalid": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "frames_to_channels": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "override_device": {
   "d": "default",
   "opts": [
    "default",
    "cpu",
    "gpu"
   ],
   "r": 1,
   "t": "enum"
  },
  "override_dtype": {
   "d": "default",
   "opts": [
    "default",
    "float64",
    "float32",
    "float16",
    "bfloat16",
    "float8_e4m3fn",
    "float8_e4m3fnuz",
    "float8_e5m2",
    "float8_e5m2fnuz",
    "float8_e8m0fnu",
    "int64",
    "int32",
    "int16",
    "int8"
   ],
   "r": 1,
   "t": "enum"
  },
  "rng_mode": {
   "d": "default",
   "opts": [
    "default",
    "separate",
    "fork"
   ],
   "r": 1,
   "t": "enum"
  },
  "rng_offset_mode": {
   "d": "disabled",
   "opts": [
    "disabled",
    "override",
    "add"
   ],
   "r": 1,
   "t": "enum"
  },
  "rng_state_offset": {
   "d": 0,
   "hi": 10000,
   "lo": 0,
   "r": 1,
   "t": "i"
  }
 },
 "SonarGuidanceConfig": {
  "end_step": {
   "d": 9999,
   "hi": 10000,
   "lo": 0,
   "r": 1,
   "t": "i"
  },
  "factor": {
   "d": 0.01,
   "hi": 2.0,
   "lo": -2.0,
   "r": 1,
   "t": "f"
  },
  "guidance_type": {
   "d": "linear",
   "opts": [
    "linear",
    "euler"
   ],
   "r": 1,
   "t": "enum"
  },
  "latent": {
   "r": 1,
   "t": "x",
   "ty": "LATENT"
  },
  "start_step": {
   "d": 0,
   "hi": 10000,
   "lo": 0,
   "r": 1,
   "t": "i"
  }
 },
 "SonarGuidedNoise": {
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "guidance_factor": {
   "d": 0.0125,
   "hi": 100.0,
   "lo": -100.0,
   "r": 1,
   "t": "f"
  },
  "latent": {
   "r": 1,
   "t": "x",
   "ty": "LATENT"
  },
  "method": {
   "d": "euler",
   "opts": [
    "euler",
    "linear"
   ],
   "r": 1,
   "t": "enum"
  },
  "normalize_noise": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "normalize_ref": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "normalize_result": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "sonar_custom_noise": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarLatentOperationAdvanced": {
  "blend_mode": {
   "d": "inject",
   "dom": "blend",
   "r": 1,
   "t": "dyn"
  },
  "blend_strength": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "difference_multiplier": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "end_sigma": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "input_multiplier": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "operation": {
   "r": 1,
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_2": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_3": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_4": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_5": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_alt": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "output_multiplier": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "start_sigma": {
   "d": -1.0,
   "hi": 10000.0,
   "lo": -1.0,
   "r": 1,
   "t": "f"
  }
 },
 "SonarLatentOperationFilteredNoise": {
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "normalize": {
   "d": "disabled",
   "r": 1,
   "t": "tri"
  },
  "normalize_noise": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "operation_1": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_2": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_3": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_4": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_5": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarLatentOperationNoise": {
  "cpu_noise": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "lazy_noise_sampler": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "normalize": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "scale_to_sigma": {
   "d": False,
   "r": 1,
   "t": "b"
  }
 },
 "SonarLatentOperationQuantileFilter": {
  "dim": {
   "d": "1",
   "opts": [
    "global",
    "0",
    "1",
    "2",
    "3",
    "4"
   ],
   "r": 1,
   "t": "enum"
  },
  "flatten": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "norm_factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": 1e-05,
   "r": 1,
   "t": "f"
  },
  "norm_power": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "quantile": {
   "d": 0.85,
   "hi": 1.0,
   "lo": -1.0,
   "r": 1,
   "t": "f"
  },
  "strategy": {
   "d": "clamp",
   "dom": "quantile_strategy",
   "r": 1,
   "t": "dyn"
  }
 },
 "SonarLatentOperationSetSeed": {
  "operation": {
   "r": 1,
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "restore_rng_state": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "seed": {
   "d": 0,
   "hi": 18446744073709551615,
   "lo": 0,
   "r": 1,
   "t": "i"
  }
 },
 "SonarModulatedNoise": {
  "dims": {
   "d": 3,
   "hi": 3,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "modulation_type": {
   "d": None,
   "opts": [
    "intensity",
    "frequency",
    "spectral_signum",
    "none"
   ],
   "r": 1,
   "t": "enum"
  },
  "normalize_noise": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "normalize_ref": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "normalize_result": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "ref_latent_opt": {
   "t": "x",
   "ty": "LATENT"
  },
  "sonar_custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "strength": {
   "d": 2.0,
   "hi": 100.0,
   "lo": -100.0,
   "r": 1,
   "t": "f"
  }
 },
 "SonarNoiseImage": {
  "blend_mode": {
   "d": "simple_add",
   "dom": "blend",
   "r": 1,
   "t": "dyn"
  },
  "blend_strength": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "channel_mode": {
   "d": "RGB",
   "opts": [
    "RGB",
    "RGBA",
    "R",
    "G",
    "B",
    "A",
    "RA",
    "GA",
    "BA",
    "RG",
    "RB",
    "GB",
    "RGA",
    "RBA",
    "GBA"
   ],
   "r": 1,
   "t": "enum"
  },
  "cpu_noise": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "dtype": {
   "d": "default",
   "opts": [
    "default",
    "float32",
    "float64",
    "float16",
    "bfloat16"
   ],
   "r": 1,
   "t": "enum"
  },
  "greyscale_mode": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "image": {
   "r": 1,
   "t": "x",
   "ty": "IMAGE"
  },
  "noise_max": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "noise_min": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "noise_multiplier": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "noise_type": {
   "d": "gaussian",
   "dom": "noise_type",
   "r": 1,
   "t": "dyn"
  },
  "normalize": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "overflow_mode": {
   "d": "clamp",
   "opts": [
    "clamp",
    "rescale"
   ],
   "r": 1,
   "t": "enum"
  },
  "pure_noise_mode": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "seed": {
   "d": 0,
   "hi": 18446744073709551615,
   "lo": 0,
   "r": 1,
   "t": "i"
  }
 },
 "SonarNormalizeNoiseToScale": {
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "dims": {
   "d": "-3, -2, -1",
   "r": 1,
   "t": "s"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "max_negative_value": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "max_positive_value": {
   "d": 4.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "mean_dims": {
   "d": "-3, -2, -1",
   "r": 1,
   "t": "s"
  },
  "mean_multiplier": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "min_negative_value": {
   "d": -4.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "min_positive_value": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "mode": {
   "d": "simple",
   "opts": [
    "simple",
    "advanced"
   ],
   "r": 1,
   "t": "enum"
  },
  "normalize": {
   "d": "disabled",
   "r": 1,
   "t": "tri"
  },
  "normalize_noise": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "std_dims": {
   "d": "-3, -2, -1",
   "r": 1,
   "t": "s"
  },
  "std_multiplier": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  }
 },
 "SonarPatternBreakNoise": {
  "blend_mode": {
   "d": "lerp",
   "dom": "blend",
   "r": 1,
   "t": "dyn"
  },
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "detail_level": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "percentage": {
   "d": 1.0,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "restore_scale": {
   "d": True,
   "r": 1,
   "t": "b"
  }
 },
 "SonarPerDimNoise": {
  "chunk_size": {
   "d": 1,
   "hi": 10000,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "dim": {
   "d": 0,
   "hi": 100,
   "lo": -100,
   "r": 1,
   "t": "i"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "normalize": {
   "d": "disabled",
   "r": 1,
   "t": "tri"
  },
  "normalize_noise": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "shrink_dim": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarPowerFilter": {
  "alpha": {
   "d": 0.0,
   "hi": 5.0,
   "lo": -5.0,
   "r": 1,
   "t": "f"
  },
  "blur": {
   "d": 0.125,
   "hi": 10.0,
   "lo": -10.0,
   "r": 1,
   "t": "f"
  },
  "compose_mode": {
   "d": None,
   "opts": [
    "max",
    "min",
    "add",
    "sub",
    "mul"
   ],
   "r": 1,
   "t": "enum"
  },
  "max_freq": {
   "d": 0.7071,
   "hi": 0.7071,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "min_freq": {
   "d": 0.0,
   "hi": 0.7071,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "oversample": {
   "d": 4,
   "hi": 128,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "pnorm": {
   "d": 2.0,
   "hi": 100.0,
   "lo": 0.125,
   "r": 1,
   "t": "f"
  },
  "power_filter_opt": {
   "t": "x",
   "ty": "SONAR_POWER_FILTER"
  },
  "rotate": {
   "d": 0.0,
   "hi": 90.0,
   "lo": -90.0,
   "r": 1,
   "t": "f"
  },
  "scale": {
   "d": 1,
   "hi": 100.0,
   "lo": -100.0,
   "r": 1,
   "t": "f"
  },
  "stretch": {
   "d": 1.0,
   "hi": 100.0,
   "lo": 0.01,
   "r": 1,
   "t": "f"
  }
 },
 "SonarPowerFilterNoise": {
  "channel_correlation": {
   "d": "1, 1, 1, 1, 1, 1",
   "r": 1,
   "t": "s"
  },
  "common_mode": {
   "d": 0.0,
   "hi": 100.0,
   "lo": -100.0,
   "r": 1,
   "t": "f"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "filter_norm_factor": {
   "d": 1.0,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "mix": {
   "d": 1.0,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "normalize_noise": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "normalize_result": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "preview": {
   "d": None,
   "opts": [
    "none",
    "no_mix",
    "mix",
    "custom"
   ],
   "r": 1,
   "t": "enum"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "sonar_power_filter": {
   "r": 1,
   "t": "x",
   "ty": "SONAR_POWER_FILTER"
  }
 },
 "SonarPowerNoise": {
  "alpha": {
   "d": 0.0,
   "hi": 5.0,
   "lo": -5.0,
   "r": 1,
   "t": "f"
  },
  "channel_correlation": {
   "d": "1, 1, 1, 1, 1, 1",
   "r": 1,
   "t": "s"
  },
  "common_mode": {
   "d": 0.0,
   "hi": 100.0,
   "lo": -100.0,
   "r": 1,
   "t": "f"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "max_freq": {
   "d": 0.7071,
   "hi": 0.7071,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "min_freq": {
   "d": 0.0,
   "hi": 0.7071,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "mix": {
   "d": 1.0,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "pnorm": {
   "d": 2.0,
   "hi": 100.0,
   "lo": 0.125,
   "r": 1,
   "t": "f"
  },
  "preview": {
   "d": "none",
   "opts": [
    "none",
    "no_mix",
    "mix"
   ],
   "r": 1,
   "t": "enum"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "rotate": {
   "d": 0.0,
   "hi": 90.0,
   "lo": -90.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "stretch": {
   "d": 1.0,
   "hi": 100.0,
   "lo": 0.01,
   "r": 1,
   "t": "f"
  },
  "time_brownian": {
   "d": False,
   "r": 1,
   "t": "b"
  }
 },
 "SonarPreviewFilter": {
  "filter_gain": {
   "d": 0.3333333333333333,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "kernel_gain": {
   "d": 0.3333333333333333,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "norm_factor": {
   "d": 1.0,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "preview_size": {
   "d": "128x128",
   "opts": [
    "128x128",
    "256x256",
    "384x256",
    "256x384",
    "768x512",
    "512x768",
    "768x768",
    "128x127",
    "127x128"
   ],
   "r": 1,
   "t": "enum"
  },
  "sonar_power_filter": {
   "r": 1,
   "t": "x",
   "ty": "SONAR_POWER_FILTER"
  }
 },
 "SonarQuantileFilteredNoise": {
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "dim": {
   "d": "1",
   "opts": [
    "global",
    "0",
    "1",
    "2",
    "3",
    "4"
   ],
   "r": 1,
   "t": "enum"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "flatten": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "norm_factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": 1e-05,
   "r": 1,
   "t": "f"
  },
  "norm_power": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "normalize": {
   "d": "disabled",
   "r": 1,
   "t": "tri"
  },
  "normalize_noise": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "quantile": {
   "d": 0.85,
   "hi": 1.0,
   "lo": -1.0,
   "r": 1,
   "t": "f"
  },
  "strategy": {
   "d": "clamp",
   "dom": "quantile_strategy",
   "r": 1,
   "t": "dyn"
  }
 },
 "SonarRandomNoise": {
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "mix_count": {
   "d": 1,
   "hi": 100,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "sonar_custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarRepeatedNoise": {
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "max_recycle": {
   "d": 1000,
   "hi": 1000,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "permute": {
   "d": "enabled",
   "opts": [
    "enabled",
    "disabled",
    "always"
   ],
   "r": 1,
   "t": "enum"
  },
  "repeat_length": {
   "d": 8,
   "hi": 100,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "sonar_custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarResizedNoise": {
  "crop_mode": {
   "d": "center",
   "opts": [
    "center",
    "top_left",
    "top_center",
    "top_right",
    "center_left",
    "center_right",
    "bottom_left",
    "bottom_center",
    "bottom_right"
   ],
   "r": 1,
   "t": "enum"
  },
  "crop_offset_horizontal": {
   "d": 0,
   "hi": 8000,
   "lo": -8000,
   "r": 1,
   "t": "i"
  },
  "crop_offset_vertical": {
   "d": 0,
   "hi": 8000,
   "lo": -8000,
   "r": 1,
   "t": "i"
  },
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "downscale_mode": {
   "d": "nearest-exact",
   "dom": "scale",
   "r": 1,
   "t": "dyn"
  },
  "downscale_strategy": {
   "d": "crop",
   "opts": [
    "crop",
    "scale"
   ],
   "r": 1,
   "t": "enum"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "height": {
   "d": 1152,
   "hi": 1073741824,
   "lo": 16,
   "r": 1,
   "t": "i"
  },
  "initial_reference": {
   "d": "prefer_crop",
   "opts": [
    "prefer_crop",
    "prefer_scale"
   ],
   "r": 1,
   "t": "enum"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "upscale_mode": {
   "d": "nearest-exact",
   "dom": "scale",
   "r": 1,
   "t": "dyn"
  },
  "width": {
   "d": 1152,
   "hi": 1073741824,
   "lo": 16,
   "r": 1,
   "t": "i"
  }
 },
 "SonarResizedNoiseAdv": {
  "crop_mode": {
   "d": "center",
   "opts": [
    "center",
    "top_left",
    "top_center",
    "top_right",
    "center_left",
    "center_right",
    "bottom_left",
    "bottom_center",
    "bottom_right"
   ],
   "r": 1,
   "t": "enum"
  },
  "crop_offset_horizontal": {
   "d": 0,
   "hi": 10000,
   "lo": -10000,
   "r": 1,
   "t": "i"
  },
  "crop_offset_vertical": {
   "d": 0,
   "hi": 10000,
   "lo": -10000,
   "r": 1,
   "t": "i"
  },
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "downscale_mode": {
   "d": "nearest-exact",
   "dom": "scale",
   "r": 1,
   "t": "dyn"
  },
  "downscale_strategy": {
   "d": "crop",
   "opts": [
    "crop",
    "scale"
   ],
   "r": 1,
   "t": "enum"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "height": {
   "d": 32.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "initial_reference": {
   "d": "prefer_crop",
   "opts": [
    "prefer_crop",
    "prefer_scale"
   ],
   "r": 1,
   "t": "enum"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "spatial_compression": {
   "d": 8,
   "hi": 10000,
   "lo": 1,
   "r": 1,
   "t": "i"
  },
  "spatial_mode": {
   "d": "relative",
   "opts": [
    "relative",
    "percentage",
    "absolute"
   ],
   "r": 1,
   "t": "enum"
  },
  "upscale_mode": {
   "d": "nearest-exact",
   "dom": "scale",
   "r": 1,
   "t": "dyn"
  },
  "width": {
   "d": 32.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  }
 },
 "SonarRippleFilteredNoise": {
  "amplitude_high": {
   "d": 0.25,
   "hi": 10000.0,
   "lo": -10000,
   "r": 1,
   "t": "f"
  },
  "amplitude_low": {
   "d": 0.15,
   "hi": 10000.0,
   "lo": -10000,
   "r": 1,
   "t": "f"
  },
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "dim": {
   "d": -1,
   "hi": 100,
   "lo": -100,
   "r": 1,
   "t": "i"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "flatten": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "mode": {
   "d": "cos",
   "opts": [
    "sin",
    "cos",
    "sin_copysign",
    "cos_copysign"
   ],
   "r": 1,
   "t": "enum"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "normalize_noise": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "offset": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000,
   "r": 1,
   "t": "f"
  },
  "period": {
   "d": 3.0,
   "hi": 10000.0,
   "lo": -10000,
   "r": 1,
   "t": "f"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "roll": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": -10000,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarScatternetFilteredNoise": {
  "custom_noise": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "magbias": {
   "d": 0.01,
   "hi": 1000.0,
   "lo": -1000.0,
   "r": 1,
   "t": "f"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "normalize_noise": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "output_mode": {
   "d": "channels_adjusted",
   "opts": [
    "channels_adjusted",
    "flat_adjusted",
    "channels",
    "flat",
    "channels_scaled",
    "flat_scaled"
   ],
   "r": 1,
   "t": "enum"
  },
  "output_offset": {
   "d": 0.0,
   "hi": 100000.0,
   "lo": -100000.0,
   "r": 1,
   "t": "f"
  },
  "padding_mode": {
   "d": "symmetric",
   "r": 1,
   "t": "s"
  },
  "per_channel_scatternet": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "scatternet_order": {
   "d": 1,
   "hi": 3,
   "lo": -3,
   "r": 1,
   "t": "i"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "use_symmetric_filter": {
   "d": False,
   "r": 1,
   "t": "b"
  }
 },
 "SonarScheduledNoise": {
  "end_percent": {
   "d": 1.0,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "fallback_sonar_custom_noise": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "model": {
   "r": 1,
   "t": "x",
   "ty": "MODEL"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "sonar_custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "start_percent": {
   "d": 0.0,
   "hi": 1.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  }
 },
 "SonarShuffledNoise": {
  "custom_noise": {
   "r": 1,
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "dims": {
   "d": "1,-2,-1",
   "r": 1,
   "t": "s"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "fork_rng": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "no_identity": {
   "d": True,
   "r": 1,
   "t": "b"
  },
  "percentages": {
   "d": "1.0,0.25,0.25",
   "r": 1,
   "t": "s"
  }
 },
 "SonarSplitNoiseChain": {
  "custom_noise": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  }
 },
 "SonarWaveletCFG": {
  "blend_mode": {
   "d": "lerp",
   "dom": "blend",
   "r": 1,
   "t": "dyn"
  },
  "blend_strength": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "end_sigma": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "fallback_mode": {
   "d": "existing",
   "opts": [
    "existing",
    "own"
   ],
   "r": 1,
   "t": "enum"
  },
  "model": {
   "r": 1,
   "t": "x",
   "ty": "MODEL"
  },
  "operation_cond": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_fallback_cfg": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_result": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_uncond": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "operation_wavelet_cfg": {
   "t": "x",
   "ty": "LATENT_OPERATION"
  },
  "start_sigma": {
   "d": -1.0,
   "hi": 10000.0,
   "lo": -1.0,
   "r": 1,
   "t": "f"
  },
  "yaml_parameters": {
   "d": "# YAML or JSON here.\n# I recommend reading the documentation at https://github.com/blepping/ComfyUI-sonar/docs/waveletcfg.md\n# For wavelet information, see: https://pytorch-wavelets.readthedocs.io/en/latest/index.html\n\n# You may override the fields from the node like start_sigma here.\n\n# This section is basically the CFG scale. (All scales sections use the same format.)\ndifference:\n    # Scale for the low frequency components.\n    yl_scale: 5.0\n\n    # Scale (or scales) for high frequency components.\n    # This can be scalar or a list or list of lists.\n    # List example:\n    #  yh_scales:\n    #      - [1, 2, 3]\n    #      - fill\n    #      - 5\n    # You can separately apply a scale to items equal to the wavelet level. Levels go from fine to coarse.\n    # If the item is a list, the three items correspond to horizontal, vertical, diagonal for DWT. (DTCWT has 6.)\n    # You can have one \"fill\" item, this will replicate the item before it however many times is necessary to\n    # match the wavelet level.\n    yh_scales: 3.0\n\n    # You can optionally include a scales_end block with yl_scale/yh_scales.\n    # to interpolate from the toplevel scales (can also be in a scales_start blockx if you prefer).\n\n    # scales_end:\n    #     yl_scale: 1.0\n    #     yh_scales: 1.0\n\n    # The following scheduling parameters only apply if scales_end exists.\n\n    # One of linear, logarithmic, exponential, half_cosine, sine\n    # Sine mode will hit the peak scales_after values in the middle of the range.\n    schedule: linear\n\n    # One of: sampling, enabled_sampling, sigmas, enabled_sigmas, step, enabled_steps\n    schedule_mode: sampling\n\n    # When enabled, flips the schedule percentage. This happens before the schedule is applied\n    # or any offset/multiplier stuff. If you want to flip the final result you can do something like\n    # schedule_offset_after: -1.0 and schedule_multiplier_after: -1.0\n    reverse_schedule: false\n\n    # Added to the percentage before the schedule function is applied.\n    schedule_offset: 0.0\n\n    # Applied to the percentage before the schedule function (but after the offset).\n    schedule_multiplier: 1.0\n\n    # Added to the percentage after the schedule function is applied.\n    schedule_offset_after: 0.0\n\n    # Applied to the percentage after the schedule function (but after the offset).\n    schedule_multiplier_after: 1.0\n\n    # Min/max for the final calculated percent. Must be between 0 and 1.\n    schedule_min: 0.0\n    schedule_max: 1.0\n\n    # If you're a crazy person, you can use non-standard blend modes for interpolating\n    # the scales. Not recommended.\n    blend_mode: lerp\n\n\n# Wavelet type\nwave: db4\n\n# Wavelet level\nlevel: 5\n\n### Start of advanced options\n\n# Mode used for padding\npadding_mode: symmetric\n\n# Mutually exclusive with DTCWT mode.\nuse_1d_dwt: false\n\n# Enables DTCWT mode.\nuse_dtcwt: false\n\n# Configuration for DTCWT, only relevant when enabled.\nbiort: near_sym_a\nqshift: qshift_a\n\n# It's also possible to set these wavelet options with an \"inv_\"\n# prefix: mode, biort, qshift, wave, padding_mode\n\n# One of: noise_norm, noise, denoised\n# Normal CFG uses denoised mode. noise_norm divides by the current sigma, noise just uses the raw noise prediction.\ntarget_mode: denoised\n\n# Can be used to scale cond before the difference is calculated.\ncond:\n    yl_scale: 1.0\n    yh_scales: 1.0\n\n# Can be used to scale uncond before the difference is calculated.\nuncond:\n    yl_scale: 1.0\n    yh_scales: 1.0\n\n# Can be used to scale the final result after blending.\nfinal:\n    yl_scale: 1.0\n    yh_scales: 1.0\n\n# Uses float64 for the wavelets/scaling/blending operations.\n# It doesn't seem to hurt performance much, but you can disable it if you want.\nhigh_precision_mode: true\n\n# Inject is just addition which is usually what you want. The normal CFG function is:\n# uncond + (cond - uncond) * cfg_scale\ndifference_blend_mode: inject\ndifference_blend_strength: 1.0\n\n# Per-rule value, can be enabled to spam your console with information when\n# rules activate, dump exactly what high/low scales are used, etc.\nverbose: false\n\n# You may include a rules block which is a list of these configuration definitions.\n# Include start_sigma/end_sigma parameters. The first matching definition will be used.\n# rules:\n#     - start_sigma: -1.0\n",
   "r": 1,
   "t": "s"
  }
 },
 "SonarWaveletFilteredNoise": {
  "custom_noise": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "custom_noise_high": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "normalize_noise": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "yaml_parameters": {
   "t": "s"
  }
 },
 "SonarWaveletNoise": {
  "custom_noise": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "factor": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "height_factor": {
   "d": 2.0,
   "hi": 10000.0,
   "lo": 0.001,
   "r": 1,
   "t": "f"
  },
  "initial_amplitude": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "normalize": {
   "d": "default",
   "r": 1,
   "t": "tri"
  },
  "normalize_noise": {
   "d": False,
   "r": 1,
   "t": "b"
  },
  "octave_height_factor": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": 0.001,
   "r": 1,
   "t": "f"
  },
  "octave_rescale_mode": {
   "d": "bilinear",
   "dom": "scale",
   "r": 1,
   "t": "dyn"
  },
  "octave_scale_mode": {
   "d": "adaptive_avg_pool2d",
   "dom": "scale",
   "r": 1,
   "t": "dyn"
  },
  "octave_width_factor": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": 0.001,
   "r": 1,
   "t": "f"
  },
  "octaves": {
   "d": 4,
   "hi": 100,
   "lo": -100,
   "r": 1,
   "t": "i"
  },
  "persistence": {
   "d": 0.5,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "post_octave_rescale_mode": {
   "d": "bilinear",
   "dom": "scale",
   "r": 1,
   "t": "dyn"
  },
  "rescale": {
   "d": 0.0,
   "hi": 10000.0,
   "lo": 0.0,
   "r": 1,
   "t": "f"
  },
  "sonar_custom_noise_opt": {
   "t": "x",
   "ty": "OCS_NOISE,SONAR_CUSTOM_NOISE"
  },
  "update_blend": {
   "d": 1.0,
   "hi": 10000.0,
   "lo": -10000.0,
   "r": 1,
   "t": "f"
  },
  "update_blend_mode": {
   "d": "lerp",
   "dom": "blend",
   "r": 1,
   "t": "dyn"
  },
  "width_factor": {
   "d": 2.0,
   "hi": 10000.0,
   "lo": 0.001,
   "r": 1,
   "t": "f"
  }
 }
}
