"""SDL declaration of the REINA GraphQL schema — the type system the
introspection endpoint serves (execution lives in schema.py resolvers).
A copy of reina_tpu/runtime/graphql/sdl.py: the SDL string is the same,
so both servers describe one API (tests/test_torch_config.py).

Type and field names mirror the reference's graphene classes
(reference graphql_schema.py:27-120,239-246,380-508) so schema-aware
tooling (graphiql, codegen, Apollo dev tools) sees the same API; the
parameter-explorer types (DiseaseParameter, Distribution) and the
timeframe field are the documented additive extensions.

EventType/MetricType enums are generated from the live intervention and
metric registries, the same way the reference builds them with
``Enum('EventType', [(iv.type.upper().replace('-', '_'), ...)])``
(reference graphql_schema.py:20-25).
"""
from __future__ import annotations

from ...config.interventions import INTERVENTIONS
from ...config.metrics import ALL_METRICS


def _enum(name: str, values) -> str:
    return "enum %s {\n  %s\n}\n" % (name, "\n  ".join(values))


EVENT_TYPE_VALUES = [iv.type.upper().replace("-", "_") for iv in INTERVENTIONS]
METRIC_TYPE_VALUES = [m.id.upper().replace("-", "_") for m in ALL_METRICS]

SDL = _enum("EventType", EVENT_TYPE_VALUES) + \
    _enum("MetricType", METRIC_TYPE_VALUES) + """
schema {
  query: Query
  mutation: Mutation
}

interface EventParameter {
  id: ID
  description: String
  required: Boolean
}

type Choice {
  id: ID
  label: String
}

type EventChoiceParameter implements EventParameter {
  id: ID
  description: String
  required: Boolean
  choices: [Choice]!
  choice: Choice
}

type EventIntParameter implements EventParameter {
  id: ID
  description: String
  required: Boolean
  minValue: Int
  maxValue: Int
  value: Int
  unit: String
}

type Event {
  id: ID
  date: String
  description: String
  type: EventType
  parameters: [EventParameter]
  modifiable: Boolean
  modifiedByUser: Boolean
}

type CategorizedIntValues {
  categories: [String]
  values: [[Int]]
}

type Metric {
  type: MetricType!
  label: String!
  description: String
  unit: String
  color: String
  isInteger: Boolean!
  isSimulated: Boolean!
  isCategorized: Boolean!
  intValues: [Int]
  floatValues: [Float]
  categorizedIntValues: CategorizedIntValues
}

type DailyMetrics {
  dates: [String]
  metrics(only: [MetricType]): [Metric]
}

type Scenario {
  id: ID!
  label: String!
  description: String
  active: Boolean!
}

type SimulationResults {
  runId: ID!
  finished: Boolean!
  endDate: String!
  predictedMetrics: DailyMetrics!
  "Run phase (additive): compiling | running | finished — a fresh config's first chunk sits inside an XLA compile for minutes"
  phase: String!
}

type PopulationAgeGroup {
  label: String!
  count: Int!
}

type SimulationArea {
  name: String!
  nameLong: String!
  totalPopulation: Int!
  ageGroups: [PopulationAgeGroup]
}

"Editable disease parameter (additive: the reference's Dash parameter table, components/params.py:144-158)"
type DiseaseParameter {
  id: ID!
  label: String!
  value: Float!
  unit: String!
}

"Sampled engine distribution (additive: the reference's Dash Distributions panel, components/params.py:170-298)"
type Distribution {
  what: String!
  categories: [String!]!
  counts: [Float!]!
}

type Query {
  availableEvents: [Event]
  activeEvents: [Event]
  simulationResults(runId: ID!): SimulationResults
  validationMetrics: DailyMetrics
  mobilityChangeMetrics: DailyMetrics
  area: SimulationArea
  scenarios: [Scenario]
  diseaseParameters: [DiseaseParameter!]
  sampleDistribution(what: String!, age: Int = 60, severity: String,
                     limitMobility: Int = 0): Distribution
  simulationDays: Int!
}

input EventInputParameter {
  id: ID!
  value: Int
  choice: String
}

input EventInput {
  date: String!
  type: EventType!
  parameters: [EventInputParameter]
}

type RunSimulation {
  runId: ID!
}

type AddEvent {
  id: ID!
}

type DeleteEvent {
  ok: Boolean
}

type ResetVariables {
  ok: Boolean
}

type ActivateScenario {
  ok: Boolean
}

type SetParameter {
  ok: Boolean
}

type ResetParameters {
  ok: Boolean
}

type SetSimulationDays {
  ok: Boolean
}

type Mutation {
  runSimulation(randomSeed: Int): RunSimulation
  addEvent(event: EventInput!): AddEvent
  deleteEvent(eventId: ID!): DeleteEvent
  resetVariables: ResetVariables
  activateScenario(scenarioId: ID!): ActivateScenario
  setParameter(parameterId: String!, value: Float!): SetParameter
  resetParameters: ResetParameters
  setSimulationDays(days: Int!): SetSimulationDays
}
"""
