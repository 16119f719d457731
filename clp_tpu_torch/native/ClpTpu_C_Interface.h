/* ClpTpu_C_Interface.h — C API for the clp_tpu_torch solver.
 *
 * Mirrors the shape of the reference's C interface (Clp_C_Interface.h:
 * opaque model handle + "C++ analogue minus prefix" naming) so existing
 * language bindings can port with minimal changes. The implementation
 * (clp_c_api.cpp) embeds CPython and drives the clp_tpu_torch package; call
 * ClpTpu_initialize() once per process before anything else.
 */
#ifndef CLPTPU_C_INTERFACE_H
#define CLPTPU_C_INTERFACE_H

#ifdef __cplusplus
extern "C" {
#endif

typedef void ClpTpuModel;

/* message callback (reference: Clp_C_Interface.h clp_callback shape; this
   build delivers the formatted catalog text as the single string part,
   with no raw double/int parts) */
typedef void (*clptpu_callback)(ClpTpuModel *model, int messageNumber,
                                int nDouble, const double *vDouble, int nInt,
                                const int *vInt, int nString, char **vString);

/* process-wide init/teardown of the embedded runtime (idempotent) */
int ClpTpu_initialize(void);
void ClpTpu_finalize(void);

ClpTpuModel *ClpTpu_newModel(void);
void ClpTpu_deleteModel(ClpTpuModel *model);

/* problem building: column-major sparse (CSC) like Clp_loadProblem */
int ClpTpu_loadProblem(ClpTpuModel *model, int numcols, int numrows,
                       const long long *start, const int *index,
                       const double *value, const double *collb,
                       const double *colub, const double *obj,
                       const double *rowlb, const double *rowub);
int ClpTpu_readMps(ClpTpuModel *model, const char *filename);
int ClpTpu_writeMps(ClpTpuModel *model, const char *filename);

void ClpTpu_setObjSense(ClpTpuModel *model, double sense); /* 1 min, -1 max */
void ClpTpu_setLogLevel(ClpTpuModel *model, int level);

/* solves */
int ClpTpu_initialSolve(ClpTpuModel *model);
int ClpTpu_dual(ClpTpuModel *model);
int ClpTpu_primal(ClpTpuModel *model);
int ClpTpu_barrier(ClpTpuModel *model);

/* status: 0 optimal, 1 primal infeasible, 2 dual infeasible, 3 stopped,
 * 4 errors, 5 user stopped (same codes as the reference) */
int ClpTpu_status(ClpTpuModel *model);
double ClpTpu_objectiveValue(ClpTpuModel *model);
int ClpTpu_numberRows(ClpTpuModel *model);
int ClpTpu_numberColumns(ClpTpuModel *model);
int ClpTpu_numberIterations(ClpTpuModel *model);

/* solution accessors copy into caller-provided buffers */
int ClpTpu_primalColumnSolution(ClpTpuModel *model, double *out, int len);
int ClpTpu_dualRowSolution(ClpTpuModel *model, double *out, int len);
int ClpTpu_reducedCosts(ClpTpuModel *model, double *out, int len);
int ClpTpu_rowActivity(ClpTpuModel *model, double *out, int len);
/* reference-name aliases */
int ClpTpu_dualColumnSolution(ClpTpuModel *model, double *out, int len);
int ClpTpu_primalRowSolution(ClpTpuModel *model, double *out, int len);
/* message callback registration (Clp_registerCallBack/Clp_clearCallBack) */
void ClpTpu_registerCallBack(ClpTpuModel *model, clptpu_callback userCallBack);
void ClpTpu_clearCallBack(ClpTpuModel *model);
/* quadratic objective: column-compressed upper triangle of Q */
int ClpTpu_loadQuadraticObjective(ClpTpuModel *model, int numberColumns,
                                  const long long *start, const int *column,
                                  const double *element);
void ClpTpu_setNumberIterations(ClpTpuModel *model, int n);

/* ----------------------------------------------------------------------
 * Full Clp_C_Interface.h surface (function-for-function, Clp_ -> ClpTpu_;
 * reference: Clp_C_Interface.h:77-554). Pointer-returning accessors hand
 * out buffers owned by the model handle, valid until the next call on the
 * same handle (the reference returns live internal arrays; an embedded
 * runtime must copy — lifetime contract is otherwise identical).
 * -------------------------------------------------------------------- */

/* version */
const char *ClpTpu_Version(void);
int ClpTpu_VersionMajor(void);
int ClpTpu_VersionMinor(void);
int ClpTpu_VersionRelease(void);

/* model edits */
void ClpTpu_resize(ClpTpuModel *model, int newNumberRows, int newNumberColumns);
void ClpTpu_deleteRows(ClpTpuModel *model, int number, const int *which);
void ClpTpu_addRows(ClpTpuModel *model, int number, const double *rowLower,
                    const double *rowUpper, const long long *rowStarts,
                    const int *columns, const double *elements);
void ClpTpu_deleteColumns(ClpTpuModel *model, int number, const int *which);
void ClpTpu_addColumns(ClpTpuModel *model, int number, const double *columnLower,
                       const double *columnUpper, const double *objective,
                       const long long *columnStarts, const int *rows,
                       const double *elements);
void ClpTpu_chgRowLower(ClpTpuModel *model, const double *rowLower);
void ClpTpu_chgRowUpper(ClpTpuModel *model, const double *rowUpper);
void ClpTpu_chgColumnLower(ClpTpuModel *model, const double *columnLower);
void ClpTpu_chgColumnUpper(ClpTpuModel *model, const double *columnUpper);
void ClpTpu_chgObjCoefficients(ClpTpuModel *model, const double *objIn);
void ClpTpu_modifyCoefficient(ClpTpuModel *model, int row, int column,
                              double newElement, int keepZero);
void ClpTpu_copyInIntegerInformation(ClpTpuModel *model, const char *information);
void ClpTpu_deleteIntegerInformation(ClpTpuModel *model);
char *ClpTpu_integerInformation(ClpTpuModel *model);

/* names */
void ClpTpu_dropNames(ClpTpuModel *model);
void ClpTpu_copyNames(ClpTpuModel *model, const char *const *rowNames,
                      const char *const *columnNames);
int ClpTpu_lengthNames(ClpTpuModel *model);
void ClpTpu_rowName(ClpTpuModel *model, int iRow, char *name);
void ClpTpu_columnName(ClpTpuModel *model, int iColumn, char *name);
void ClpTpu_setRowName(ClpTpuModel *model, int iRow, const char *name);
void ClpTpu_setColumnName(ClpTpuModel *model, int iColumn, const char *name);
void ClpTpu_problemName(ClpTpuModel *model, int maxNumberCharacters, char *array);
int ClpTpu_setProblemName(ClpTpuModel *model, int maxNumberCharacters,
                          const char *array);

/* parameters */
double ClpTpu_primalTolerance(ClpTpuModel *model);
void ClpTpu_setPrimalTolerance(ClpTpuModel *model, double value);
double ClpTpu_dualTolerance(ClpTpuModel *model);
void ClpTpu_setDualTolerance(ClpTpuModel *model, double value);
double ClpTpu_dualObjectiveLimit(ClpTpuModel *model);
void ClpTpu_setDualObjectiveLimit(ClpTpuModel *model, double value);
double ClpTpu_objectiveOffset(ClpTpuModel *model);
void ClpTpu_setObjectiveOffset(ClpTpuModel *model, double value);
int ClpTpu_maximumIterations(ClpTpuModel *model);
void ClpTpu_setMaximumIterations(ClpTpuModel *model, int value);
double ClpTpu_maximumSeconds(ClpTpuModel *model);
void ClpTpu_setMaximumSeconds(ClpTpuModel *model, double value);
int ClpTpu_hitMaximumIterations(ClpTpuModel *model);
double ClpTpu_optimizationDirection(ClpTpuModel *model);
void ClpTpu_setOptimizationDirection(ClpTpuModel *model, double value);
double ClpTpu_getObjSense(ClpTpuModel *model);
double ClpTpu_dualBound(ClpTpuModel *model);
void ClpTpu_setDualBound(ClpTpuModel *model, double value);
double ClpTpu_infeasibilityCost(ClpTpuModel *model);
void ClpTpu_setInfeasibilityCost(ClpTpuModel *model, double value);
int ClpTpu_perturbation(ClpTpuModel *model);
void ClpTpu_setPerturbation(ClpTpuModel *model, int value);
int ClpTpu_algorithm(ClpTpuModel *model);
void ClpTpu_setAlgorithm(ClpTpuModel *model, int value);
int ClpTpu_logLevel(ClpTpuModel *model);
double ClpTpu_getSmallElementValue(ClpTpuModel *model);
void ClpTpu_setSmallElementValue(ClpTpuModel *model, double value);
void ClpTpu_setRandomSeed(ClpTpuModel *model, int seed);
void ClpTpu_scaling(ClpTpuModel *model, int mode);
int ClpTpu_scalingFlag(ClpTpuModel *model);

/* matrix / rim queries (handle-owned buffers) */
long long ClpTpu_getNumElements(ClpTpuModel *model);
const long long *ClpTpu_getVectorStarts(ClpTpuModel *model);
const int *ClpTpu_getIndices(ClpTpuModel *model);
const int *ClpTpu_getVectorLengths(ClpTpuModel *model);
const double *ClpTpu_getElements(ClpTpuModel *model);
double *ClpTpu_rowLower(ClpTpuModel *model);
double *ClpTpu_rowUpper(ClpTpuModel *model);
double *ClpTpu_objective(ClpTpuModel *model);
double *ClpTpu_columnLower(ClpTpuModel *model);
double *ClpTpu_columnUpper(ClpTpuModel *model);
const double *ClpTpu_getRowLower(ClpTpuModel *model);
const double *ClpTpu_getRowUpper(ClpTpuModel *model);
const double *ClpTpu_getObjCoefficients(ClpTpuModel *model);
const double *ClpTpu_getColLower(ClpTpuModel *model);
const double *ClpTpu_getColUpper(ClpTpuModel *model);
int ClpTpu_getNumRows(ClpTpuModel *model);
int ClpTpu_getNumCols(ClpTpuModel *model);

/* solves (full family) */
int ClpTpu_initialDualSolve(ClpTpuModel *model);
int ClpTpu_initialPrimalSolve(ClpTpuModel *model);
int ClpTpu_initialBarrierSolve(ClpTpuModel *model);
int ClpTpu_initialBarrierNoCrossSolve(ClpTpuModel *model);
int ClpTpu_dualWithValuesPass(ClpTpuModel *model, int ifValuesPass);
int ClpTpu_primalWithValuesPass(ClpTpuModel *model, int ifValuesPass);
void ClpTpu_idiot(ClpTpuModel *model, int tryhard);
int ClpTpu_crash(ClpTpuModel *model, double gap, int pivot);

/* status / solution queries */
int ClpTpu_secondaryStatus(ClpTpuModel *model);
void ClpTpu_setProblemStatus(ClpTpuModel *model, int problemStatus);
void ClpTpu_setSecondaryStatus(ClpTpuModel *model, int status);
int ClpTpu_getIterationCount(ClpTpuModel *model);
int ClpTpu_isAbandoned(ClpTpuModel *model);
int ClpTpu_isProvenOptimal(ClpTpuModel *model);
int ClpTpu_isProvenPrimalInfeasible(ClpTpuModel *model);
int ClpTpu_isProvenDualInfeasible(ClpTpuModel *model);
int ClpTpu_isPrimalObjectiveLimitReached(ClpTpuModel *model);
int ClpTpu_isDualObjectiveLimitReached(ClpTpuModel *model);
int ClpTpu_isIterationLimitReached(ClpTpuModel *model);
int ClpTpu_primalFeasible(ClpTpuModel *model);
int ClpTpu_dualFeasible(ClpTpuModel *model);
double ClpTpu_getObjValue(ClpTpuModel *model);
const double *ClpTpu_getRowActivity(ClpTpuModel *model);
const double *ClpTpu_getColSolution(ClpTpuModel *model);
void ClpTpu_setColSolution(ClpTpuModel *model, const double *input);
const double *ClpTpu_getRowPrice(ClpTpuModel *model);
const double *ClpTpu_getReducedCost(ClpTpuModel *model);
double ClpTpu_sumDualInfeasibilities(ClpTpuModel *model);
int ClpTpu_numberDualInfeasibilities(ClpTpuModel *model);
double ClpTpu_sumPrimalInfeasibilities(ClpTpuModel *model);
int ClpTpu_numberPrimalInfeasibilities(ClpTpuModel *model);
void ClpTpu_checkSolution(ClpTpuModel *model);

/* rays (malloc'd; free with ClpTpu_freeRay) */
double *ClpTpu_infeasibilityRay(ClpTpuModel *model);
double *ClpTpu_unboundedRay(ClpTpuModel *model);
void ClpTpu_freeRay(ClpTpuModel *model, double *ray);

/* basis status (codes match ClpSimplex::Status: 0 free, 1 basic,
 * 2 at upper, 3 at lower, 5 fixed) */
int ClpTpu_statusExists(ClpTpuModel *model);
unsigned char *ClpTpu_statusArray(ClpTpuModel *model);
void ClpTpu_copyinStatus(ClpTpuModel *model, const unsigned char *statusArray);
int ClpTpu_getColumnStatus(ClpTpuModel *model, int sequence);
int ClpTpu_getRowStatus(ClpTpuModel *model, int sequence);
void ClpTpu_setColumnStatus(ClpTpuModel *model, int sequence, int value);
void ClpTpu_setRowStatus(ClpTpuModel *model, int sequence, int value);

/* user pointer */
void ClpTpu_setUserPointer(ClpTpuModel *model, void *pointer);
void *ClpTpu_getUserPointer(ClpTpuModel *model);

/* whole-model save/restore */
int ClpTpu_saveModel(ClpTpuModel *model, const char *fileName);
int ClpTpu_restoreModel(ClpTpuModel *model, const char *fileName);
void ClpTpu_printModel(ClpTpuModel *model, const char *prefix);

/* ClpSolve options object (reference: ClpSolve_* family) */
typedef void ClpTpuSolve;
ClpTpuSolve *ClpTpuSolve_new(void);
void ClpTpuSolve_delete(ClpTpuSolve *solve);
void ClpTpuSolve_setSolveType(ClpTpuSolve *, int method, int extraInfo);
int ClpTpuSolve_getSolveType(ClpTpuSolve *);
void ClpTpuSolve_setPresolveType(ClpTpuSolve *, int amount, int extraInfo);
int ClpTpuSolve_getPresolveType(ClpTpuSolve *);
int ClpTpuSolve_getPresolvePasses(ClpTpuSolve *);
void ClpTpuSolve_setSubstitution(ClpTpuSolve *, int value);
int ClpTpuSolve_substitution(ClpTpuSolve *);
void ClpTpuSolve_setDoDual(ClpTpuSolve *, int doDual);
int ClpTpuSolve_doDual(ClpTpuSolve *);
void ClpTpuSolve_setDoSingleton(ClpTpuSolve *, int v);
int ClpTpuSolve_doSingleton(ClpTpuSolve *);
void ClpTpuSolve_setDoDoubleton(ClpTpuSolve *, int v);
int ClpTpuSolve_doDoubleton(ClpTpuSolve *);
void ClpTpuSolve_setDoTripleton(ClpTpuSolve *, int v);
int ClpTpuSolve_doTripleton(ClpTpuSolve *);
void ClpTpuSolve_setDoForcing(ClpTpuSolve *, int v);
int ClpTpuSolve_doForcing(ClpTpuSolve *);
void ClpTpuSolve_setDoImpliedFree(ClpTpuSolve *, int v);
int ClpTpuSolve_doImpliedFree(ClpTpuSolve *);
void ClpTpuSolve_setDoDupcol(ClpTpuSolve *, int v);
int ClpTpuSolve_doDupcol(ClpTpuSolve *);
void ClpTpuSolve_setDoDuprow(ClpTpuSolve *, int v);
int ClpTpuSolve_doDuprow(ClpTpuSolve *);
void ClpTpuSolve_setDoSingletonColumn(ClpTpuSolve *, int v);
int ClpTpuSolve_doSingletonColumn(ClpTpuSolve *);
int ClpTpu_initialSolveWithOptions(ClpTpuModel *model, ClpTpuSolve *);

#ifdef __cplusplus
}
#endif
#endif /* CLPTPU_C_INTERFACE_H */
