# Mozart's primary contribution — the chiplet ecosystem-accelerator
# codesign stack (operator IR -> perf/energy model -> SA/GA/convex-hull/PnR
# -> cost model -> deployment policy), its batched numerics on the card.
# Sibling subpackages implement the serving substrate the policies deploy
# onto.
from .chiplets import Chiplet, default_pool, full_design_space
from .codesign import (BasicDesign, CodesignResult, best_homogeneous_design,
                       design_for_network, homogeneous_design, run_codesign,
                       unconstrained_design)
from .convexhull import (PipelineJob, PipelineSolution,
                         default_latency_grid, solve_pipeline,
                         solve_pipeline_batch, solve_pipeline_bruteforce)
from .costmodel import (SystemCost, chiplet_re_cost, die_cost, die_yield,
                        price_stage_options, stage_hw_cost, system_cost)
from .engine import (DEFAULT_ENGINE, EvaluationEngine, clear_all_caches,
                     engine_enabled, set_engine_enabled)
from .fusion import (FusionGroup, FusionResult, GAConfig, Genome,
                     Requirement, evaluate_genomes, groups_from_genome,
                     initial_population, optimize_fusion)
from .memory import DDR5, GDDR7, HBM3, LPDDR5, MEMORY_POOL, MemoryType
from .operators import (LMSpec, Operator, OperatorGraph, lm_operator_graph,
                        paper_workloads)
from .perfmodel import (StageConfig, StageOption, StageOptionColumns,
                        StageOptionSet, enumerate_stage_options,
                        evaluate_group, evaluate_group_batch, gpu_eval,
                        is_memory_bound, scale_option)
from .pnr import PnrResult, place_and_route
from .policy import (ExecutionPolicy, OperatorPolicy, policy_from_design,
                     policy_from_json)
from .pool import PoolResult, SAConfig, anneal_pool, evaluate_pool
from .scenarios import (SCENARIOS, Scenario, SpecDecodeScenario,
                        get_scenario)

__all__ = [n for n in dir() if not n.startswith("_")]
