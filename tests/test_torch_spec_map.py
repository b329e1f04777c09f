"""The spec map: every test of the JAX package's test files, held to the
port test(s) that check the same claim, or to a reason from a closed list.

The JAX tests are the reference's behaviour specs. The public-name diff in
test_torch_imports.py shows that every name has a twin; this map shows the
same for behaviour. A JAX test maps to port tests (`file::function`) that
check its claim directly, or that hold the same function to the JAX
package's at the stated tolerance on the kind of input the JAX test uses.
The only other entry is a reason from REASONS: the TPU workarounds the
port leaves out as mechanisms, each tied to the JAX tests it may cover.

Both sides are parsed with `ast`; nothing is imported. A new JAX test
without an entry, a port test renamed or removed, or a reason off the list
fails here.
"""

import ast
from pathlib import Path

TESTS = Path(__file__).resolve().parent

# reason -> the JAX tests it may cover
REASONS = {
    "tpu_workaround: chunked_scan, the TPU trip-count nesting of the HMC "
    "scan (the port runs a plain loop)": (
        "test_hmc.py::test_chunked_scan_matches_plain_scan",
        "test_hmc.py::test_chunked_scan_fresh_pad_keys",
        "test_hmc.py::test_chunked_scan_rejects_bad_leading_dim"),
    "tpu_workaround: _chunked_index_scan, the TPU loop nesting of the "
    "SplineAR inverse": (
        "test_bijectors.py::test_spline_ar_chunked_inverse_matches_flat",),
    "tpu_workaround: EAM's split/cheb lowerings of the table lookup (the "
    "port keeps `take`)": (
        "test_eam.py::test_spline_impls_agree",),
    "tpu_workaround: a subprocess that runs only on a TPU": (
        "test_eam.py::test_tabulated_eam_inside_hmc_on_tpu",),
    "tpu_workaround: the graft harness (__graft_entry__.py), which no "
    "entry point of either package uses": (
        "test_parallel.py::test_graft_dryrun_multichip",),
}


SPEC_MAP = {
    # ------------------------------------------------------ test_bijectors
    "test_bijectors.py::test_affine_coupling": [
        "test_torch_flow.py::test_bijector_matches_jax"],
    "test_bijectors.py::test_spline_coupling": [
        "test_torch_spline.py::test_layer_matches_jax",
        "test_torch_spline.py::test_layer_param_grads_match_jax"],
    "test_bijectors.py::test_spline_coupling_nonprefix_masks": [
        "test_torch_spline.py::test_layer_matches_jax"],
    "test_bijectors.py::test_spline_ar": [
        "test_torch_spline.py::test_layer_matches_jax"],
    "test_bijectors.py::test_spline_ar_dim1": [
        "test_torch_spline.py::test_ar_dim1_has_no_conditioner",
        "test_torch_spline.py::test_spline_ar_dim1_round_trips"],
    "test_bijectors.py::test_spline_ar_chunked_inverse_matches_flat":
        "tpu_workaround: _chunked_index_scan, the TPU loop nesting of the "
        "SplineAR inverse",
    "test_bijectors.py::test_masked_affine_ar": [
        "test_torch_spline.py::test_layer_matches_jax"],
    "test_bijectors.py::test_actnorm": [
        "test_torch_flow.py::test_bijector_matches_jax"],
    "test_bijectors.py::test_invertible_linear": [
        "test_torch_elementary.py::test_forward_matches_jax",
        "test_torch_elementary.py::test_inverse_matches_jax_and_round_trips"],
    "test_bijectors.py::test_radial_exact_inverse": [
        "test_torch_elementary.py::test_forward_matches_jax",
        "test_torch_elementary.py::test_inverse_matches_jax_and_round_trips"],
    "test_bijectors.py::test_planar_forward_logdet": [
        "test_torch_elementary.py::test_forward_matches_jax",
        "test_torch_elementary.py::"
        "test_planar_has_no_inverse_and_checks_its_nonlinearity"],
    "test_bijectors.py::test_chain_and_repeat_equivalence": [
        "test_torch_flow.py::test_repeat_equals_its_chain"],
    "test_bijectors.py::test_chain_roundtrip_heterogeneous": [
        "test_torch_flow.py::test_chain_roundtrip_heterogeneous"],
    "test_bijectors.py::test_jit_and_grad_compatible": [
        "test_torch_spline.py::test_layer_param_grads_match_jax"],
    "test_bijectors.py::test_affine_coupling_s_cap_roundtrip_and_bound": [
        "test_torch_flow.py::test_bijector_matches_jax"],
    "test_bijectors.py::test_deep_wide_realnvp_stack_finite_with_s_cap": [
        "test_torch_flow.py::test_deep_wide_realnvp_stack_finite_with_s_cap"],
    # ---------------------------------------------------- test_config_apps
    "test_config_apps.py::test_config_parses_and_builds": [
        "test_torch_config_apps.py::test_config_parses_to_the_jax_values",
        "test_torch_config_apps.py::"
        "test_config_builds_or_names_what_is_missing"],
    "test_config_apps.py::test_boxlength_inference_matches_reference": [
        "test_torch_config_apps.py::test_config_parses_to_the_jax_values"],
    "test_config_apps.py::test_train_cli_and_fe_eval": [
        "test_torch_config_apps.py::test_train_cli_and_fe_eval"],
    "test_config_apps.py::test_sample_data_app": [
        "test_torch_config_apps.py::test_cli_pipeline_on_a_tiny_lj_solid"],
    "test_config_apps.py::test_sample_data_segmented_generation": [
        "test_torch_config_apps.py::test_sample_data_segmented_generation"],
    "test_config_apps.py::test_checkpoint_restores_jax_arrays": [
        "test_torch_fe_train.py::"
        "test_checkpoint_round_trip_casts_to_the_template"],
    "test_config_apps.py::test_lj_update_data_kwarg_attaches_dataset": [
        "test_torch_lj_io.py::test_lj_samples_its_attached_data",
        "test_torch_eam.py::test_eamiron_samples_its_attached_data"],
    "test_config_apps.py::test_fused_resume_is_bit_exact": [
        "test_torch_fe_train.py::test_resume_is_bit_exact"],
    "test_config_apps.py::test_fused_resume_already_complete": [
        "test_torch_fe_train.py::test_resume_when_already_complete"],
    "test_config_apps.py::test_fused_hmc_mixing_gate": [
        "test_torch_fe_train.py::test_mixing_gate"],
    "test_config_apps.py::test_train_cli_hmc_mix": [
        "test_torch_parity.py::test_a_shrunk_lj_solid_through_every_step"],
    "test_config_apps.py::test_best_checkpoint_is_copy_of_fresh_last": [
        "test_torch_fe_train.py::test_best_is_a_copy_of_a_fresh_last"],
    # ------------------------------------------------------------ test_eam
    "test_eam.py::test_load_setfl_shapes": [
        "test_torch_eam.py::test_load_setfl_equals_jax"],
    "test_eam.py::test_spline_impls_agree":
        "tpu_workaround: EAM's split/cheb lowerings of the table lookup (the "
        "port keeps `take`)",
    "test_eam.py::test_tabulated_matches_analytic_energy": [
        "test_torch_eam.py::test_table_against_analytic"],
    "test_eam.py::test_tabulated_forces_match_analytic": [
        "test_torch_eam.py::test_table_against_analytic"],
    "test_eam.py::test_eamiron_setfl_path_jits_and_vmaps": [
        "test_torch_eam.py::test_eamiron_log_prob_matches_jax",
        "test_torch_eam.py::test_table_against_analytic"],
    "test_eam.py::test_config_wires_input_dir_to_setfl": [
        "test_torch_eam.py::test_config_fe_branch"],
    "test_eam.py::test_setfl_truncated_file_raises": [
        "test_torch_eam.py::test_truncated_setfl_raises"],
    "test_eam.py::test_spline_matches_known_cubic": [
        "test_torch_eam.py::test_natural_cubic_coeffs_equal_jax"],
    "test_eam.py::test_tabulated_eam_inside_hmc_on_tpu":
        "tpu_workaround: a subprocess that runs only on a TPU",
    # ----------------------------------------------------- test_estimators
    "test_estimators.py::test_bar_recovers_exact_free_energy": [
        "test_torch_estimators_fe.py::test_bar_and_zwanzig_match_jax"],
    "test_estimators.py::test_zwanzig_both_directions": [
        "test_torch_estimators_fe.py::test_bar_and_zwanzig_match_jax"],
    "test_estimators.py::test_mbar_recovers_exact_free_energy": [
        "test_torch_estimators_fe.py::test_mbar_matches_jax"],
    "test_estimators.py::test_mbar_consistent_with_bar": [
        "test_torch_estimators_fe.py::test_two_state_mbar_equals_bar"],
    "test_estimators.py::test_ess_iid_and_correlated": [
        "test_torch_ess.py::test_scalar_functions_match_jax"],
    "test_estimators.py::test_fe_diff_no_training_recovers_gaussian_gap": [
        "test_torch_estimators_fe.py::test_fe_diff_no_training_matches_jax"],
    "test_estimators.py::test_bulk_ess_rank_normalization_invariance": [
        "test_torch_ess.py::test_scalar_functions_match_jax"],
    "test_estimators.py::test_tail_ess_iid_vs_sticky_tails": [
        "test_torch_ess.py::test_scalar_functions_match_jax"],
    "test_estimators.py::test_bulk_ess_per_dim_shapes": [
        "test_torch_ess.py::test_per_dim_functions_match_jax"],
    "test_estimators.py::test_bulk_ess_splits_chains": [
        "test_torch_ess.py::test_scalar_functions_match_jax"],
    # ------------------------------------------------------ test_f32_stack
    "test_f32_stack.py::test_f32_roundtrip_at_scale": [
        "test_torch_spline.py::test_f32_roundtrip_at_scale"],
    "test_f32_stack.py::test_f32_matches_f64_at_scale": [
        "test_torch_spline.py::test_f32_matches_f64_at_scale"],
    "test_f32_stack.py::test_f32_inverse_matches_f64_at_scale": [
        "test_torch_spline.py::test_f32_inverse_matches_f64_at_scale"],
    # -------------------------------------------------------- test_fe_eval
    "test_fe_eval.py::test_generate_from_nf_non_multiple_count": [
        "test_torch_estimators_fe.py::"
        "test_generate_and_evaluate_honour_any_count"],
    "test_fe_eval.py::test_evaluate_non_multiple_count": [
        "test_torch_estimators_fe.py::"
        "test_generate_and_evaluate_honour_any_count"],
    "test_fe_eval.py::test_fe_diff_relaxes_both_ensembles": [
        "test_torch_estimators_fe.py::test_fe_diff_relaxes_both_ensembles"],
    "test_fe_eval.py::test_relaxed_fe_diff_consistent_with_unrelaxed": [
        "test_torch_estimators_fe.py::"
        "test_relaxed_fe_diff_consistent_with_unrelaxed"],
    # --------------------------------------------------------- test_fields
    "test_fields.py::test_gff_log_prob_matches_dense_gaussian": [
        "test_torch_gff.py::test_gff_matches_jax",
        "test_torch_gff.py::test_gff_samples_in_law"],
    "test_fields.py::test_gff_exact_sampling_moments": [
        "test_torch_gff.py::test_gff_samples_in_law"],
    "test_fields.py::test_gff_channels_have_distinct_masses": [
        "test_torch_gff.py::test_gff_matches_jax"],
    "test_fields.py::test_gff_action_is_local_quadratic_form": [
        "test_torch_gff.py::test_gff_matches_jax"],
    "test_fields.py::test_phi4_action_brute_force": [
        "test_torch_phi4.py::"
        "test_action_log_prob_grad_and_magnetization_match_jax"],
    "test_fields.py::test_gff_registry_and_polymer_data_roundtrip": [
        "test_torch_gff.py::test_config_gaussian_field_branch",
        "test_torch_gff.py::test_polymer_cli_end_to_end"],
    "test_fields.py::test_phi4_config_end_to_end": [
        "test_torch_phi4.py::test_phi4_config_end_to_end"],
    # ------------------------------------------------------------ test_hmc
    "test_hmc.py::test_hmc_standard_normal_moments": [
        "test_torch_per_point.py::test_per_point_meets_jax_bands"],
    "test_hmc.py::test_hmc_adapts_step_size_and_mass": [
        "test_torch_per_point.py::test_per_point_meets_jax_bands"],
    "test_hmc.py::test_hmc_rhat_and_ess": [
        "test_torch_hmc.py::test_hmc_rhat_and_ess"],
    "test_hmc.py::test_hmc_ill_conditioned_with_adaptation": [
        "test_torch_hmc.py::test_run_hmc_ill_conditioned_moments"],
    "test_hmc.py::test_hmc_rejects_divergent_proposals": [
        "test_torch_per_point.py::"
        "test_hmc_kernel_rejects_divergent_proposal"],
    "test_hmc.py::test_chunked_scan_matches_plain_scan":
        "tpu_workaround: chunked_scan, the TPU trip-count nesting of the HMC "
        "scan (the port runs a plain loop)",
    "test_hmc.py::test_chunked_scan_fresh_pad_keys":
        "tpu_workaround: chunked_scan, the TPU trip-count nesting of the HMC "
        "scan (the port runs a plain loop)",
    "test_hmc.py::test_chunked_scan_rejects_bad_leading_dim":
        "tpu_workaround: chunked_scan, the TPU trip-count nesting of the HMC "
        "scan (the port runs a plain loop)",
    "test_hmc.py::test_chain_batched_kernel_matches_vmapped": [
        "test_torch_per_point.py::test_run_hmc_per_point_matches_jax"],
    "test_hmc.py::test_chain_batched_spline_pullback_smoke": [
        "test_torch_spline.py::test_neutra_spline_run_matches_jax"],
    # ----------------------------------------------------- test_hmc_pallas
    "test_hmc_pallas.py::test_pallas_accept_select_matches_reference": [
        "test_torch_ops_hmc.py::test_ref_matches_jax_f32",
        "test_torch_ops_hmc.py::test_ref_matches_jax_f64"],
    "test_hmc_pallas.py::test_batched_kernel_matches_vmapped_single": [
        "test_torch_per_point.py::test_transition_matches_jax"],
    # ------------------------------------------------------------- test_io
    "test_io.py::test_xyz_roundtrip": [
        "test_torch_lj_io.py::test_xyz_round_trip_and_parsers_agree"],
    "test_io.py::test_native_parser_matches_python": [
        "test_torch_lj_io.py::test_xyz_round_trip_and_parsers_agree",
        "test_torch_lj_io.py::test_parsers_agree_on_the_shipped_lattices"],
    "test_io.py::test_native_parser_speed": [
        "test_torch_lj_io.py::test_native_parser_speed"],
    "test_io.py::test_read_xyz_dispatches": [
        "test_torch_lj_io.py::test_xyz_round_trip_and_parsers_agree"],
    "test_io.py::test_malformed_file_raises_native": [
        "test_torch_lj_io.py::test_malformed_file_raises_native"],
    "test_io.py::test_lammps_writer": [
        "test_torch_lj_io.py::test_lammps_writer_matches_jax"],
    "test_io.py::test_sample_data_wraps_periodic_positions": [
        "test_torch_config_apps.py::test_cli_pipeline_on_a_tiny_lj_solid"],
    # ------------------------------------------------------- test_nuts_smc
    "test_nuts_smc.py::test_nuts_standard_normal": [
        "test_torch_nuts.py::test_nuts_standard_normal",
        "test_torch_per_point.py::test_per_point_meets_jax_bands"],
    "test_nuts_smc.py::test_nuts_adapts_to_anisotropy": [
        "test_torch_nuts.py::test_nuts_adapts_to_anisotropy",
        "test_torch_per_point.py::test_per_point_meets_jax_bands"],
    "test_nuts_smc.py::test_nuts_survives_nan_energies": [
        "test_torch_nuts.py::test_nuts_survives_nan_energies"],
    "test_nuts_smc.py::test_nuts_explores_from_bad_init": [
        "test_torch_nuts.py::test_nuts_explores_from_bad_init"],
    "test_nuts_smc.py::test_systematic_resampling_unbiased": [
        "test_torch_smc.py::test_systematic_resampling_unbiased"],
    "test_nuts_smc.py::test_ess_from_log_weights": [
        "test_torch_smc.py::test_ess_from_log_weights_matches_jax"],
    "test_nuts_smc.py::test_smc_gaussian_shift_evidence": [
        "test_torch_smc.py::test_smc_gaussian_shift_evidence"],
    "test_nuts_smc.py::test_smc_estimates_evidence_ratio": [
        "test_torch_smc.py::test_smc_estimates_evidence_ratio"],
    "test_nuts_smc.py::test_nuts_eight_schools_vs_stan_reference": [
        "test_torch_nuts.py::test_nuts_eight_schools_vs_stan_reference"],
    # ------------------------------------------------------- test_parallel
    "test_parallel.py::test_sharded_train_matches_single_device": [
        "test_torch_parallel.py::test_sharded_train_step"],
    "test_parallel.py::test_sharded_batch_placement": [
        "test_torch_parallel.py::test_sharded_train_step",
        "test_torch_parallel.py::test_mesh_collectives_and_errors"],
    "test_parallel.py::test_hmc_sharded_chains": [
        "test_torch_parallel.py::test_sharded_hmc"],
    "test_parallel.py::test_hmc_sharded_matches_unsharded": [
        "test_torch_parallel.py::test_sharded_hmc"],
    "test_parallel.py::test_smc_sharded_matches_unsharded": [
        "test_torch_parallel.py::test_sharded_smc"],
    "test_parallel.py::test_graft_dryrun_multichip":
        "tpu_workaround: the graft harness (__graft_entry__.py), which no "
        "entry point of either package uses",
    # ----------------------------------------------------- test_relaxation
    "test_relaxation.py::test_collect_hmc_data_shapes_and_acceptance": [
        "test_torch_relaxation.py::test_collect_hmc_data_matches_jax",
        "test_torch_relaxation.py::"
        "test_collect_hmc_data_draws_from_a_generator"],
    "test_relaxation.py::test_relaxation_step_lowers_energy": [
        "test_torch_relaxation.py::test_relaxation_step_matches_jax"],
    "test_relaxation.py::"
    "test_integrate_out_v_close_to_direct_logp_for_identity_dynamics": [
        "test_torch_relaxation.py::test_integrate_out_v_matches_jax"],
    "test_relaxation.py::test_metropolize_filters_high_energy": [
        "test_torch_relaxation.py::test_metropolize_matches_jax"],
    "test_relaxation.py::test_force_matching_zero_for_matched_model": [
        "test_torch_relaxation.py::test_diagnostics_match_jax"],
    "test_relaxation.py::"
    "test_relaxation_forwards_soft_factor_to_integrate_out_v": [
        "test_torch_relaxation.py::test_relaxation_step_matches_jax"],
    "test_relaxation.py::test_integrate_out_v_uses_soft_momenta": [
        "test_torch_relaxation.py::test_integrate_out_v_matches_jax"],
    "test_relaxation.py::test_relaxation_caps_displacement": [
        "test_torch_relaxation.py::"
        "test_cap_keeps_an_overlapping_frame_finite_in_float32"],
    "test_relaxation.py::test_collect_hmc_data_writes_xyz": [
        "test_torch_relaxation.py::test_collect_hmc_data_matches_jax"],
    # ------------------------------------------------------------ test_rqs
    "test_rqs.py::test_round_trip_inside_and_outside": [
        "test_torch_rqs.py::test_twin_matches_jax",
        "test_torch_spline.py::test_layer_matches_jax"],
    "test_rqs.py::test_logdet_matches_autodiff": [
        "test_torch_rqs.py::test_twin_matches_jax"],
    "test_rqs.py::test_identity_tails": [
        "test_torch_rqs.py::test_twin_matches_jax",
        "test_torch_rqs.py::test_twin_nan_and_inf_match_jax"],
    "test_rqs.py::test_monotone_increasing": [
        "test_torch_rqs.py::test_twin_matches_jax"],
    "test_rqs.py::test_boundary_maps_to_boundary": [
        "test_torch_rqs.py::test_twin_matches_jax"],
    "test_rqs.py::test_asymmetric_domains": [
        "test_torch_rqs.py::test_twin_matches_jax"],
    "test_rqs.py::test_float32_accuracy": [
        "test_torch_rqs.py::test_twin_float32_accuracy"],
    # ----------------------------------------------------- test_rqs_pallas
    "test_rqs_pallas.py::test_fused_matches_reference": [
        "test_torch_rqs.py::test_twin_matches_pallas_kernel_f32"],
    "test_rqs_pallas.py::test_fused_batched_shape": [
        "test_torch_per_point.py::test_fused_rqs_under_torch_func"],
    "test_rqs_pallas.py::test_fused_roundtrip": [
        "test_torch_rqs.py::test_twin_matches_pallas_kernel_f32",
        "test_torch_rqs.py::test_twin_float32_accuracy"],
    "test_rqs_pallas.py::test_fused_gradients_match_reference": [
        "test_torch_rqs_vjp.py::test_vjp_plain_matches",
        "test_torch_rqs.py::test_autograd_function_matches_twin"],
    "test_rqs_pallas.py::test_fused_vmap_rule_matches_reference": [
        "test_torch_per_point.py::test_fused_rqs_under_torch_func"],
    "test_rqs_pallas.py::test_fused_grad_of_vmap_matches_reference": [
        "test_torch_per_point.py::test_fused_rqs_under_torch_func"],
    "test_rqs_pallas.py::test_apply_rqs_under_vmap_matches_direct": [
        "test_torch_per_point.py::test_fused_rqs_under_torch_func"],
    # ------------------------------------------------------------- test_vi
    "test_vi.py::test_planar_stack_vi": [
        "test_torch_vi.py::test_planar_stack_vi",
        "test_torch_vi.py::test_objective_and_grads_match_jax",
        "test_torch_vi.py::test_short_fit_matches_jax_step_for_step"],
    "test_vi.py::test_radial_stack_vi": [
        "test_torch_vi.py::test_radial_stack_vi",
        "test_torch_vi.py::test_objective_and_grads_match_jax",
        "test_torch_vi.py::test_short_fit_matches_jax_step_for_step"],
    "test_vi.py::test_elbo_is_negative_reverse_kl": [
        "test_torch_vi.py::test_elbo_is_negative_reverse_kl",
        "test_torch_vi.py::test_elbo_is_minus_reverse_kl_on_the_same_latents"],
    "test_vi.py::test_elbo_bounds_log_evidence": [
        "test_torch_vi.py::test_elbo_bounds_log_evidence"],
    "test_vi.py::test_spline_flow_on_correlated_gaussian": [
        "test_torch_vi.py::test_spline_flow_on_correlated_gaussian",
        "test_torch_vi.py::test_objective_and_grads_match_jax",
        "test_torch_vi.py::test_short_fit_matches_jax_step_for_step"],
}


def functions_of(path):
    """`file::function` of every test function in a test file: at module
    level and in classes."""
    tree = ast.parse(path.read_text())
    names = []
    for node in tree.body:
        defs = node.body if isinstance(node, ast.ClassDef) else [node]
        names += [d.name for d in defs
                  if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and d.name.startswith("test_")]
    return {f"{path.name}::{name}" for name in names}


def jax_tests():
    out = set()
    for path in sorted(TESTS.glob("test_*.py")):
        if not path.name.startswith("test_torch_"):
            out |= functions_of(path)
    return out


def port_tests():
    out = set()
    for path in sorted(TESTS.glob("test_torch_*.py")):
        out |= functions_of(path)
    return out


def test_every_jax_test_has_an_entry():
    tests = jax_tests()
    assert len(tests) > 100  # the JAX package's files were found
    assert sorted(tests - set(SPEC_MAP)) == [], "JAX tests without an entry"
    assert sorted(set(SPEC_MAP) - tests) == [], "entries of no JAX test"


def test_every_named_port_test_exists():
    have = port_tests()
    named = {t for v in SPEC_MAP.values() if isinstance(v, list) for t in v}
    assert named and all(v for v in SPEC_MAP.values())
    assert sorted(named - have) == [], "port tests that do not exist"


def test_every_reason_is_on_the_closed_list():
    for test, entry in SPEC_MAP.items():
        if isinstance(entry, str):
            assert entry in REASONS, (test, entry)
            assert test in REASONS[entry], f"{test}: {entry!r} is not its"
        else:
            assert isinstance(entry, list), (test, entry)
    used = {v for v in SPEC_MAP.values() if isinstance(v, str)}
    assert used == set(REASONS), "a reason that holds no test"

